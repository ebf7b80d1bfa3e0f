"""Data-parallel ResNet training with horovod_tpu_torch (the PyTorch/CUDA
port).

The port's ``examples/jax/jax_resnet50.py``: ``hvd.init``, one broadcast
of rank 0's initial params, the local value-and-grad of the port's
functional ``resnet_loss`` (NHWC, batch-norm running statistics carried
as a tree), ``hvd.allreduce_gradients(op=Average)`` on the lane, then
SGD with momentum 0.9 at ``base_lr x size`` (``torch.optim.SGD(momentum=
0.9, dampening=0)`` computes optax's ``sgd(momentum=0.9)``). It runs on
the card (bf16 compute, f32 params); ``--no-cuda`` keeps it on the CPU
(gloo), and without it and without a card ``hvd.init()`` raises. It
prints the loss per step and images/s.

Run:  horovodrun-torch --local-cards python examples/torch_port/torch_resnet50.py --image-size 224
      horovodrun-torch -np 2 python examples/torch_port/torch_resnet50.py --no-cuda --depth 18 --image-size 32
Synthetic imagenet-shaped data keeps it hermetic.
"""

import argparse
import time

import numpy as np
import torch

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.models import ResNetConfig, resnet_init, resnet_loss
from horovod_tpu_torch.parallel._tree import tree_leaves


def make_train_step(cfg, params, lr, device):
    """``step(state, batch) -> (loss, new_state)``: the local
    value-and-grad of ``resnet_loss``, the gradients averaged over the
    ranks on the lane, then SGD with momentum 0.9 on ``params`` in
    place."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.SGD(leaves, lr=lr, momentum=0.9, dampening=0)

    def step(state, batch):
        loss, new_state = resnet_loss(params, state, batch, cfg,
                                      device=device)
        grads = torch.autograd.grad(loss, leaves)
        grads = hvd.allreduce_gradients(list(grads), op=hvd.Average)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
        return loss.detach(), new_state

    return step


def synthetic_batch(rng, n, side, device):
    """``n`` random NHWC images and labels, made on the host from
    ``rng``."""
    return {"images": torch.from_numpy(
                rng.rand(n, side, side, 3).astype(np.float32)).to(device),
            "labels": torch.from_numpy(
                rng.randint(0, 1000, n).astype(np.int64)).to(device)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=50,
                    choices=[18, 34, 50, 101, 152])
    ap.add_argument("--batch-size", type=int, default=32,
                    help="per-rank batch size")
    ap.add_argument("--image-size", type=int, default=64,
                    help="synthetic image side (224 for the real thing)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--base-lr", type=float, default=0.0125)
    ap.add_argument("--no-cuda", action="store_true",
                    help="run on the CPU (gloo, f32) instead of the card")
    args = ap.parse_args()

    hvd.init(device="cpu" if args.no_cuda else None)
    device = torch.device("cpu" if args.no_cuda else "cuda")
    cfg = ResNetConfig(depth=args.depth, num_classes=1000,
                       compute_dtype="float32" if args.no_cuda
                       else "bfloat16")

    params, state = resnet_init(cfg, torch.Generator().manual_seed(0),
                                device=device)
    # One broadcast so every rank starts from rank 0's init.
    hvd.broadcast_parameters(params, root_rank=0)
    # Reference recipe: scale the learning rate by world size.
    step = make_train_step(cfg, params, args.base_lr * hvd.size(), device)

    rng = np.random.RandomState(hvd.rank())  # each rank: its own shard
    s = args.image_size
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = synthetic_batch(rng, args.batch_size, s, device)
        loss, state = step(state, batch)
        if hvd.rank() == 0:
            print(f"step {i} loss {float(loss):.4f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    imgs = args.steps * args.batch_size * hvd.size()
    if hvd.rank() == 0:
        print(f"{imgs / dt:.1f} images/sec over {hvd.size()} ranks "
              f"(depth {args.depth}, {s}x{s})", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
