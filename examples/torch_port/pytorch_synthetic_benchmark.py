"""Synthetic-data throughput benchmark for the port's torch frontend.

``examples/torch/pytorch_synthetic_benchmark.py`` with the port's
``import horovod_tpu_torch.torch as hvd``, run on the card (``--no-cuda``
keeps it on the CPU, gloo; without it and without a card, ``hvd.init()``
raises). Same CLI shape: fixed random batches, timed allreduce-per-step
training, per-worker img/sec plus the all-worker total.

torchvision isn't required: ``--model resnet50`` uses it when
installed, otherwise a built-in ResNet-ish convnet stands in (declared
in the output so numbers aren't confused with the torchvision model).

Run:
    horovodrun-torch --local-cards python examples/torch_port/pytorch_synthetic_benchmark.py
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd


class SmallResNetish(torch.nn.Module):
    """Stand-in when torchvision is absent: conv stem + 4 residual
    stages + fc, ~11M params."""

    class Block(torch.nn.Module):
        def __init__(self, cin, cout, stride=1):
            super().__init__()
            self.c1 = torch.nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.b1 = torch.nn.BatchNorm2d(cout)
            self.c2 = torch.nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.b2 = torch.nn.BatchNorm2d(cout)
            self.skip = (torch.nn.Conv2d(cin, cout, 1, stride, bias=False)
                         if (stride != 1 or cin != cout)
                         else torch.nn.Identity())

        def forward(self, x):
            h = F.relu(self.b1(self.c1(x)))
            h = self.b2(self.c2(h))
            return F.relu(h + self.skip(x))

    def __init__(self, num_classes=1000):
        super().__init__()
        self.stem = torch.nn.Sequential(
            torch.nn.Conv2d(3, 64, 7, 2, 3, bias=False),
            torch.nn.BatchNorm2d(64), torch.nn.ReLU(),
            torch.nn.MaxPool2d(3, 2, 1))
        stages = []
        cin = 64
        for cout, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
            stages += [self.Block(cin, cout, stride), self.Block(cout, cout)]
            cin = cout
        self.stages = torch.nn.Sequential(*stages)
        self.fc = torch.nn.Linear(512, num_classes)

    def forward(self, x):
        h = self.stages(self.stem(x))
        return self.fc(h.mean(dim=(2, 3)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet50")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-warmup-batches", type=int, default=2)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=5)
    p.add_argument("--fp16-allreduce", action="store_true",
                   help="compress gradients to fp16 on the wire")
    p.add_argument("--no-cuda", action="store_true",
                   help="run on the CPU (gloo) instead of the card")
    args = p.parse_args()

    hvd.init(device="cpu" if args.no_cuda else None)
    device = torch.device("cpu" if args.no_cuda else "cuda")
    torch.manual_seed(42)

    try:
        from torchvision import models
    except ImportError:
        models = None
    if models is not None:
        # A bad --model name fails loudly rather than silently swapping
        # in the stand-in with a wrong label.
        model = getattr(models, args.model)()
        model_name = args.model
    else:
        model = SmallResNetish()
        model_name = f"{args.model} (builtin stand-in; torchvision absent)"
    model = model.to(device)

    optimizer = torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size())
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    data = torch.randn(args.batch_size, 3, 224, 224).to(device)
    target = torch.randint(0, 1000, (args.batch_size,)).to(device)

    def benchmark_step():
        optimizer.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        optimizer.step()

    if hvd.rank() == 0:
        print(f"Model: {model_name}, batch size {args.batch_size}, "
              f"{hvd.size()} worker(s)")
    for _ in range(args.num_warmup_batches):
        benchmark_step()

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.time()
        for _ in range(args.num_batches_per_iter):
            benchmark_step()
        ips = args.batch_size * args.num_batches_per_iter / (time.time() - t0)
        img_secs.append(ips)
        if hvd.rank() == 0:
            print(f"Iter #{i}: {ips:.1f} img/sec per worker")

    if hvd.rank() == 0:
        mean, conf = np.mean(img_secs), 1.96 * np.std(img_secs)
        print(f"Img/sec per worker: {mean:.1f} +-{conf:.1f}")
        print(f"Total img/sec on {hvd.size()} worker(s): "
              f"{mean * hvd.size():.1f} +-{conf * hvd.size():.1f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
