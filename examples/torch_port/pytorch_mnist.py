"""Data-parallel MNIST with horovod_tpu_torch.torch (the PyTorch/CUDA port).

``examples/torch/pytorch_mnist.py`` with the port's ``import
horovod_tpu_torch.torch as hvd``, run on the card: per-parameter
gradient hooks fire async allreduces during backward; ``opt.step()``
synchronizes them all. ``--no-cuda`` keeps the job on the CPU (gloo);
without it and without a card, ``hvd.init()`` raises.

Run:  horovodrun-torch --local-cards python examples/torch_port/pytorch_mnist.py
      horovodrun-torch -np 2 python examples/torch_port/pytorch_mnist.py --no-cuda
"""

import argparse

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(784, 128)
        self.fc2 = nn.Linear(128, 10)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--fp16-allreduce", action="store_true")
    ap.add_argument("--no-cuda", action="store_true",
                    help="run on the CPU (gloo) instead of the card")
    args = ap.parse_args()

    hvd.init(device="cpu" if args.no_cuda else None)
    device = torch.device("cpu" if args.no_cuda else "cuda")
    torch.manual_seed(1234)

    rng = np.random.RandomState(42)
    x = torch.from_numpy(rng.rand(4096, 784).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 4096).astype(np.int64))
    x, y = x[hvd.rank()::hvd.size()], y[hvd.rank()::hvd.size()]
    x, y = x.to(device), y.to(device)

    model = Net().to(device)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    opt = torch.optim.SGD(model.parameters(), lr=args.lr * hvd.size())
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters(),
        compression=compression)

    # Start everyone from rank 0's weights & optimizer state.
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    step = 0
    for epoch in range(args.epochs):
        for i in range(0, x.shape[0] - args.batch_size, args.batch_size):
            opt.zero_grad()
            out = model(x[i:i + args.batch_size])
            loss = F.cross_entropy(out, y[i:i + args.batch_size])
            loss.backward()          # hooks launch async allreduces
            opt.step()               # synchronize + apply averaged grads
            if step % 50 == 0 and hvd.rank() == 0:
                print(f"epoch {epoch} step {step} loss {loss.item():.4f}")
            step += 1

    final = hvd.allreduce(loss.detach(), name="final_loss")
    if hvd.rank() == 0:
        print(f"done: mean final loss = {final.item():.4f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
