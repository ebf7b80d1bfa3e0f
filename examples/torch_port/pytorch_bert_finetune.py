"""Data-parallel BERT fine-tuning with horovod_tpu_torch.torch (the
PyTorch/CUDA port) + fp16 gradient compression.

``examples/torch/pytorch_bert_finetune.py`` with the port's ``import
horovod_tpu_torch.torch as hvd``, run on the card (``--no-cuda`` keeps
it on the CPU, gloo; without it and without a card, ``hvd.init()``
raises). It needs the ``transformers`` package.

Reference analog: examples/pytorch/pytorch_bert.py-style fine-tune —
BASELINE config #3's shape: a transformers BERT encoder, the torch
DistributedOptimizer's per-parameter async allreduce hooks, and
``Compression.fp16`` halving every gradient payload on the wire.
Hermetic: the model is built from a (tiny, random-init) config and the
task is synthetic sequence classification, so nothing downloads.

Run:  horovodrun-torch --local-cards python examples/torch_port/pytorch_bert_finetune.py
"""

import argparse
import time

import numpy as np
import torch

import horovod_tpu_torch.torch as hvd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--no-fp16", action="store_true",
                    help="disable fp16 gradient compression")
    ap.add_argument("--no-cuda", action="store_true",
                    help="run on the CPU (gloo) instead of the card")
    args = ap.parse_args()

    hvd.init(device="cpu" if args.no_cuda else None)
    device = torch.device("cpu" if args.no_cuda else "cuda")
    torch.manual_seed(1234)  # same init everywhere; broadcast confirms

    from transformers import BertConfig, BertForSequenceClassification

    heads = max(args.hidden // 32, 1)
    while args.hidden % heads:
        heads -= 1  # largest head count that divides hidden_size
    cfg = BertConfig(vocab_size=1024, hidden_size=args.hidden,
                     num_hidden_layers=args.layers,
                     num_attention_heads=heads,
                     intermediate_size=4 * args.hidden,
                     max_position_embeddings=args.seq_len, num_labels=2)
    model = BertForSequenceClassification(cfg).to(device)

    compression = (hvd.Compression.none if args.no_fp16
                   else hvd.Compression.fp16)
    base_opt = torch.optim.AdamW(model.parameters(), lr=5e-5 * hvd.size())
    opt = hvd.DistributedOptimizer(
        base_opt, named_parameters=model.named_parameters(),
        compression=compression)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(base_opt, root_rank=0)

    rng = np.random.RandomState(100 + hvd.rank())  # rank-local shard
    tokens = torch.from_numpy(
        rng.randint(0, cfg.vocab_size,
                    (args.steps * args.batch_size, args.seq_len)))
    # Synthetic but learnable: the label is a parity bit of the tokens.
    labels = (tokens.sum(1) % 2).long()
    tokens, labels = tokens.to(device), labels.to(device)

    model.train()
    t0 = time.perf_counter()
    for step in range(args.steps):
        i = step * args.batch_size
        opt.zero_grad()
        out = model(input_ids=tokens[i:i + args.batch_size],
                    labels=labels[i:i + args.batch_size])
        out.loss.backward()   # hooks fire async fp16 allreduces here
        opt.step()            # synchronizes + applies averaged grads
        if hvd.rank() == 0:
            print(f"step {step}: loss {out.loss.item():.4f}", flush=True)
    if hvd.rank() == 0:
        dt = time.perf_counter() - t0
        n = args.steps * args.batch_size
        print(f"{n / dt:.1f} seq/sec/rank "
              f"({hvd.size() * n / dt:.1f} aggregate), "
              f"compression={'none' if args.no_fp16 else 'fp16'}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
