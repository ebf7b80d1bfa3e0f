#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card of
compute capability >= 9.0::

    python3 chip_smoke.py

It builds the port's hand-written kernels from the checkout's sources
and drives the port's serving and training paths at the full width of
the flagship dense Llama and of the repo's sparse-MoE Llama, and BERT-
Large's MLM training (also under elastic recovery), and the Horovod lane
(its autotuner, parole door, wire codecs and cross-plane allreduce too),
a job started by the port's launcher, ZeRO-1 on both lanes, the Adam
update's kernel, ResNet-50 training, Mixtral-8x7B's GShard step, and
tensor-parallel replays of the mesh path's blocks (the flagship's,
BERT-Large's and the grouped dispatch's), the disaggregated serving
loop (with a killed decode rank) and ZeRO's re-layout, the pipeline
schedules replayed on one card at Llama-3-8B's width and the remat modes
dots, attn+ffn and attn+gate+qkv, and the flagship's training
checkpointed in flight and resumed (with the master-weights variants),
in phases; any failed phase exits
non-zero before the result line. ``python3 chip_smoke.py
--launched-worker static|elastic DIR`` is one rank of that job, and
``--serve-worker f32|bf16 DIR`` one rank of phase 27's serving drill.

1. Card, power limit, torch/CUDA versions; kernel build time.
2. Each kernel against its plain PyTorch version at the main paths'
   shapes (and a long prompt / long cache / ragged T): max error,
   kernel, plain and library times, and the card's bound for the same
   work. K1 forward, K2/K3 backward (dq, dk, dv) at the dense (Hkv4)
   and MoE (Hkv8) train shapes, K4 decode, K5 grouped matmul and K6
   (its dlhs and tgmm) at the MoE train, prefill and decode shapes (gate/
   up and down; K5 splits the contraction at decode), at f32 and on a
   skewed routing with an empty group. Every kernel takes two routes,
   chosen by dtype: bf16 on the wgmma kernels, f32 on the FMA kernels;
   each bf16 case reports its route, TFLOP/s (K1-K3, K5, K6), the
   compiled kernel's registers, spills and shared memory, and the FMA
   kernel's time on the same inputs (``earlier_ms``). K3 and K4 give the
   same bits on two launches; K4 at both generate paths' decode shapes
   (B16 Hkv4 n_rep4 and Hkv8 n_rep2, S192) is one CUDA launch a call,
   and reports its device time. Every bf16 launch of K1-K6 on the main
   paths below must take the wgmma route.
3. ``llama_generate``: greedy, batch 16, prompt 128, 64 new tokens;
   K1 must launch once per layer, K4 once per layer per decode step.
4. ``DecodeEngine``: 16 requests of 17-128 prompt tokens, 32 new
   tokens each, all arriving at once; K1 once per layer per prefill.
5. Parity: at flagship widths in f32 (2 layers), the engine's tokens
   equal ``llama_generate``'s for every request, with requests admitted
   mid-flight.
6. Training: ``make_split_train_step(llama_loss, fused_adam(3e-4))`` at
   batch 4 x 2048 tokens, ``remat="attn+gate"``, bf16 params: one
   warm-up step, 5 timed steps on one fixed batch; K1, K2 and K3 must
   each launch 14 times per grad call, the Adam kernel once a param leaf
   a step, and the loss must fall. Also the
   lm_head's f32-output product (which path this torch takes, its cost).
7. Training parity: at flagship widths in f32 (2 layers, batch 2 x
   256), loss and gradients on the card match the plain CPU path, and
   the remat modes none/full/attn/attn+gate/dots/attn+ffn/attn+gate+qkv
   agree with K1 launching 2/4/2/2/4/2/2 times per grad call.
8. MoE training: ``benchmarks/moe_bench.py``'s config and step (split
   step, ``fused_adam(3e-4)``, 2 microbatches, ``remat="moe"``) at
   batch 4 x 2048: one warm-up and 4 timed steps; per grad call K5 and
   K6's two halves launch 36 times each and K1-K3 12 times each, the
   Adam kernel once a param leaf a step; the loss must fall.
   Active-parameter MFU, peak memory, a profile. First,
   one layer's grouped FFN runs forward and backward with no host sync.
9. MoE serving: ``llama_generate`` b16 (K5 3 per layer in prefill and
   in each decode step) and b1 (decode by the top-K gather: no K5);
   ``DecodeEngine`` with 8 requests at once (max_batch 8: K5) and 2 at
   max_batch 1 (the top-K gather).
10. MoE parity at f32 (2 layers): loss and gradients on the card
   against the CPU; the nine remat modes agree, with K5 launching
   6/12/12/12/10/6/12/12/12 times per grad call (none/full/attn/
   attn+gate/attn+moe/moe/dots/attn+ffn/attn+gate+qkv); engine tokens
   equal ``llama_generate``'s. Then the
   same 2-layer grad call at bf16 on the card (K1, K2, K5, K6 on wgmma)
   against bf16 on the CPU (the plain versions).
11. The Horovod eager lane (``horovod_tpu_torch.torch``) on NCCL at
   world size 1 (one card): the NCCL version and each group's backend;
   every op on CUDA tensors in f32, bf16, f16 and int32 (Adasum floating
   only), prescaled and postscaled, in place and out of place, grouped
   and single, each result on the card and equal to its analytic value,
   one NCCL call per response and none on gloo; a tensor written on a
   side stream behind a long kernel is read only after the write (and,
   as a control, read stale without the lane's wait on its producer),
   with the timeline on; ``/healthz`` and ``/metrics`` of the debug
   server (``HOROVOD_DEBUG_PORT=0``); ``broadcast_parameters`` over the
   flagship's params; the bf16 gradients of one flagship backward (phase
   6's shape) through ``grouped_allreduce_`` (one atomic response) and
   per-leaf ``allreduce_async_`` (the optimizer's traffic, 64 MiB
   threshold), 13 sets each, with the response cache on and again with
   ``HOROVOD_CACHE_CAPACITY=0``: Average bit for bit, the same responses
   per steady set, per leaf one miss per leaf and then only hits, the
   metrics' ``device_ops`` equal to the bytes sent; ms per set beside
   the bound of the bytes the lane moves, the lane's host time per
   active cycle and per response, the device's idle share; one per-leaf
   set under a timeline (every gradient negotiates and runs
   ``NCCL_ALLREDUCE``) and ms per set with it on; ``SyncBatchNorm``'s
   function on a ``[32, 256, 56, 56]`` activation, f32 and bf16, against
   ``nn.BatchNorm2d`` (forward, backward, running statistics, both
   times); a CUDA tensor on a lane opened with ``device="cpu"`` raises.
12. K1, K2 and K3's bias variant (BERT's padding mask) against their
   plain versions at BERT-Large's attention (B16 H16 T512 D64 bf16,
   non-causal): a padding bias of seeded lengths in [128, 512] with one
   sequence all padding (exact zeros there), a random bias N(0, 3^2);
   f32 on the FMA route (B2 T128). Errors, kernel ms, the FMA kernels'
   ms on the bf16 inputs, the plain versions' ms, SDPA with the bias as
   its additive mask (forward, backward), and the bound of the pairs the
   data needs; K3 the same bits on two launches.
13. BERT-Large MLM training (``BertConfig.large()``: vocab 30522, d1024,
   L24, H16, d_ff 4096, bf16 compute, f32 params, remat; ~335 M
   params) at B16 x T512 with seeded padding lengths in [128, 512] and
   15% of the real tokens masked: ``make_split_train_step(bert_mlm_loss,
   fused_adam(1e-4))``, 2 warm-up steps, 5 timed (ms/step the median),
   tok/s, MFU by ``bench.py:123 _mfu_row``'s formula, peak memory, the
   f32 logits product's share, a profile; per step K1 launches 48 times
   with the bias (forward and the remat recompute), K2 and K3 24, all on
   wgmma, the Adam kernel once a param leaf; the loss must fall.
14. ``bert_forward`` alone at the same batch: ms, K1 24 per call.
15. BERT parity at BERT-Large widths, 2 layers, B4 x T128, lengths
   128/77/1/0: f32 loss and gradients on the card (the FMA route)
   against the CPU's plain path; bf16 on the card (wgmma) against bf16
   on the CPU, each gradient leaf held to 2x a floor measured in the run.
16. K1, K2 and K3's offsets variant (one ring-attention step) against
   their plain versions at the chunks of a seq=4 ring over the flagship's
   attention at B1 x T16384 (H16 Hkv4 D128 bf16, chunks of 4096): past
   (12288, 0), diagonal, wholly future (0, 12288: o, dq, dk, dv exactly 0
   and a finite lse <= -1e29), misaligned (4096 + 37, 4096), Tq 4096 /
   Tk 2048, a random lse cotangent; f32 on the FMA route (B2 T256).
   Errors, kernel, FMA-kernel and plain ms, SDPA with the chunk's boolean
   mask (forward, backward; it returns no lse), the bound of the pairs
   the mask leaves.
17. The seq=4 ring replayed on one card at B1 x T16384: each rank's 4
   steps through the port's ring step loop (``ring_flash_steps``, the
   rotation supplied from the pre-split K/V chunks), forward and
   backward, 4 offsets launches each of K1, K2 and K3 a rank, all on
   wgmma, ms per rank; the joined o, dq, dk, dv against one-card K1-K3
   over the whole sequence (2x a floor measured in the run + 1e-2).
   Multi-rank ring and Ulysses on NCCL are not run: one card.
18. Elastic training on NCCL at world size 1, BERT-Large at full width
   (phase 13's config and seeded padding batch): (a) the reference's
   torch elastic API, an ``nn.Module`` over ``bert_init``'s params
   trained by ``hvd.DistributedOptimizer(Adam(1e-4))`` under
   ``@hvd.elastic.run`` with ``hvd.elastic.TorchState(model, optimizer,
   step=0)``, 6 steps with a commit every 2, each step's gradients one
   ``grouped_allreduce_async_`` Average on the card (at world size 1
   the optimizer registers no hooks); (b) the port's split step
   (``fused_adam(1e-4)``) under ``TreeState(carry=...)``, 4 steps, one
   commit. The training function raises ``HorovodInternalError`` once
   with the state a step past step 2's commit: in (a) at step 4, after
   the backward (the gradient group in flight); in (b) after step 3's
   update (``fused_adam`` writes the carry in place). The state restores
   step 2's commit (bit for bit, on the card, in its dtypes),
   ``reset()`` shuts the lane down and re-inits it at epoch 1 with a new
   NCCL group, the post-reset hooks run, and steps 3.. replay. Each
   run's params and Adam moments within 1e-3 (norm-relative) of a
   fault-free run from the same seed (bit-identity printed), replayed
   losses within 1e-3; K1-K3 launch 23 grad calls' worth, all biased
   and on wgmma. ms per commit (device to host of the state) beside the
   bound at the pinned copy rate measured here, per restore, per reset
   (shutdown, init, NCCL communicator init), and the replayed ms/step
   beside phase 13's. A peer lost on NCCL needs more than one card.
19. The lane's autotuner and the parole door on NCCL at world size 1,
   no kernel launched (asserted): (a) ``HOROVOD_AUTOTUNE=1`` over the
   flagship's grouped bf16 gradient set (phase 11's leaf shapes, random
   values) until the tuner converges (3 warm-up windows + 20 scored, at
   most 60 s): every log row well formed, the last the converged point,
   equal to ``hvd.metrics()["knobs"]``; ms per set (median of 10) at the
   converged knobs and at the default ones (64 MiB, 1 ms, no tuner)
   beside phase 11's bound, and the host ms per active cycle at each;
   (b) ``HOROVOD_REJOIN_PORT``: rank 0's door and its TCP store at size
   1, ``/healthz``'s ``pending_rejoiners`` 0, the commit poll's us,
   BERT-Large ``TreeState`` commits (phase 18's carry) with the door and
   without, an injected ``HorovodInternalError`` whose reset reads the
   door (``parole_freeze``); (c) ``hvd.elastic.shrink(set())``: the
   world re-formed at the next epoch with a new NCCL group, its ms
   beside phase 18's resets. A grown world (1 -> 2) on NCCL needs a
   second card.
20. The lane's wire codecs and the cross-plane allreduce on one card:
   (a) each codec kernel (``csrc/wire_codec.cu``: bf16 and int8 encode,
   decode-accumulate, decode-scale) against its plain version bit for
   bit, on the edge cases (NaN payloads, infinities, denormals, empty,
   all-zero and all-denormal records; a NaN that a decoder's arithmetic
   makes is NaN on both, the card's canonical one) and on the flagship's
   f32 gradient set (phase 11's leaf shapes, ~1.43 B elements) cut into
   the lane's 64 MiB fusion buckets, each cut as a 4-rank compressed
   allreduce cuts its buffer; ms per 64 MiB bucket (median of CUDA-event launches)
   beside the HBM bound, the plain version's ms and, for the bf16
   encode, ``to(torch.bfloat16)``'s; (b) the data plane's allreduce over
   4 emulated ranks in one process, one thread and one ``DataPlane``
   each, only the transport replaced by device copies (flat, 2 x 2
   hierarchical, bf16 and int8 on every hop, bf16 on the cross hop
   alone, int8 with a bf16 cross hop): uncompressed exact fills equal
   the flat sum bit for bit, every mode agrees bitwise across the ranks
   and stays within N^2 2^-7 (bf16) or N^2 2^-6 (int8) of the f64 sum on
   a 64 MiB bucket a rank, the same run on the CPU's plain versions
   gives the same bits, and every codec kernel launches (counted from 0
   over this run: the main path of the codecs); (c) the lane at world
   size 1 on NCCL under ``HOROVOD_CROSS_PLANE=hier`` and
   ``HOROVOD_WIRE_COMPRESSION=int8``: the rank-0 warning, split 0, the
   modes in ``metrics()["knobs"]``, an f32 grouped set bit-identical to
   the run without the settings (no rounding at size 1), ``wire`` bytes
   0 and no codec launch. A real 2-slice NCCL world needs 4 cards.
21. The port's launcher on the card: (a) ``python -m
   horovod_tpu_torch.runner.launch --check-build`` exits 0 with its
   CUDA, NCCL (the version ``torch.cuda.nccl.version()`` gives) and gloo
   rows on; (b) a ``--local-cards`` launch (one rank a card) of this
   script in its worker mode: 3 steps of phase 13's BERT-Large step on
   the split step, each step's gradients one ``grouped_allreduce_async_``
   Average on the lane; every rank on ``cuda:{local_rank}`` with rank
   0's losses, and at one card the losses and the final params' digest
   bit-identical to the same 3 steps in this process; the children load
   the kernel libraries phase 1 built (none rebuilt); (c) the same job
   under the port's ``ElasticDriver`` (``--min-np 1 --max-np N``, a
   discovery script printing ``localhost:N``, ``TreeState`` committed
   every step): rank 0's first attempt exits 17 after step 1, its slot
   is respawned, the job exits 0 with (b)'s digest; (d) launch to first
   step of (b) and (c), (b)'s step ms beside phase 13's, and the
   respawn's seconds from the worker's exit to its replacement's first
   step.
22. ZeRO-1 at world size 1 on the flagship (B4 x T2048, ``attn+gate``,
   3 steps from one seed): (a) ``make_split_train_step(zero=
   ZeroConfig(size=1))`` with ``fused_adam(3e-4)``, unfused and fused
   (``HOROVOD_JIT_FUSION``), losses, params and state bit-identical to
   the replicated split step's; (b) the same with ``fused_master_adam``
   (f32 params, bf16 compute); ms/step, first step, peak memory and state
   bytes of all three, K1-K3 14 launches each per grad call on wgmma,
   the Adam kernel (its master variant in (b)) once a param leaf a step
   replicated and once a ``ADAM_CHUNK`` of a bucket's shard under ZeRO;
   (c) ``hvd.DistributedFusedAdam`` on NCCL over the flagship's bf16
   gradients, ``zero=True`` with ``overlap`` on and off and ``zero=
   False``, each bit-identical to ``fused_adam``'s apply, ms per apply
   (median of 10) beside ``fused_adam``'s, the lane's ops under
   ``zero=True`` reducescatter and allgather only; (d)
   ``hvd.make_fused_train_step`` fused (allgathers in flight into the
   next step) and unfused: the same losses and params, equal to (a)'s
   replicated losses, ms/step; (e) the lane's reducescatter on gloo in
   f32 and bf16 on this torch. Across cards: ``tests/
   test_torch_zero_cuda_ranks.py``.
23. The Adam update's kernel (``csrc/adam.cu``): (a) both variants
   (moments in the parameter dtype, bf16 and f32; an f32 master with a
   bf16 or f32 gradient and its compute cast) against the plain version
   bit for bit over 3 successive counts, at a length off the 8-element
   vector and on a view one element off the 16-byte alignment; (b) one
   apply over the flagship's leaves (bf16, and its f32 master with bf16
   gradients) bit for bit leaf by leaf, then ms per apply of the kernel,
   the plain version and ``torch._fused_adam_`` (the library yardstick,
   never on the path) beside the bound of the bytes moved.
24. ResNet-50 (depth 50, 1000 classes, f32 params, bf16 compute, NHWC)
   trained by ``examples/torch_port/torch_resnet50.py``'s step with the
   lane open at world size 1 on NCCL, B128 x 224 x 224 x 3: images/s
   (the median step after 2 warm-up), ms/step, peak memory, the
   profiler's busy share, no kernel of the port launched (the JAX
   package has none on this path); then depth 18, width 8, f32 with TF32
   off: the loss, gradients and running statistics on the card against
   the CPU on the same weights.
25. The mesh path's blocks at full width: (a) Mixtral-8x7B (vocab
   32000, d4096, H32/Hkv8, d_ff 14336, 8 experts top-2; cut to 2 of its
   32 layers, ~3.16 B params) without a mesh through the GShard dispatch
   (``moe_impl="gshard"``, capacity factor 1.25, ``remat="attn+gate"``),
   B2 x T2048, ``make_split_train_step(llama_loss, fused_adam(3e-4))``:
   one warm-up and 3 timed steps, finite losses, ms/step, peak memory,
   K1-K3 once a layer per grad call on wgmma, no K5/K6, the Adam kernel
   once a leaf a step; then at capacity factor E/K (C = T: nothing can
   drop) one grad call through GShard and one through the grouped path
   (K5/K6 3 a layer), the losses to 1e-2 and each gradient leaf to 5e-2
   (norm-relative). (b) A ``tensor=4`` replay of one flagship layer
   (H16/Hkv4: 4 heads and 1 kv head a shard): each shard's blocks
   (``shard_params`` with ``llama_partition_rules``) through
   ``_attention_block`` and ``_dense_ffn``, the code the mesh runs, with
   a ``None`` group, forward and backward at B2 x T2048; the four
   partial outputs and input gradients summed on the card against the
   unsharded blocks (2e-2 norm-relative); K1-K3 four launches, on wgmma.
   Phase 2 holds K1-K3 at both attention shapes. Across cards:
   ``tests/test_torch_mesh_cuda_ranks.py``.
26. The mesh path's tensor shards of BERT-Large and of the grouped
   dispatch: (a) one BERT-Large layer (H16 D64, d_ff 4096) as four
   ``tensor`` shards (``bert_partition_rules``; 4 heads a shard) through
   ``bert._attention_block`` and ``_mlp_block`` with a ``None`` group, B16
   x T512 with seeded padding: K1-K3's bias variant four launches each,
   the partial sums and input gradients against the unsharded layer
   (2e-2 norm-relative); (b) one Mixtral layer's dropless grouped
   expert FFN as four shards (F 14336 -> 3584 a shard), B2 x T2048: K5
   and K6's halves 12 launches each, the partial outputs, input
   gradients and joined weight gradients against the unsharded layer.
   Phase 2 holds K1-K3's bias variant at H8 and H4 and K5/K6 at Mixtral's
   ``tensor=2`` and ``tensor=4`` expert shards beside the bound, the
   plain versions, SDPA and ``torch._grouped_mm``.
27. The disaggregated serving loop (``serving/service.py``) and ZeRO's
   re-layout: (a) ``ServingLoop`` at world size 1 over the flagship in
   bf16 with int8 KV, 16 requests on a Poisson trace (50 rps) with phase
   4's prompt lengths (17-128) and 32 new tokens each: every request
   served, K1 once a layer a prefill and K4 never (the continuous-
   batching step's ragged attention is the plain chain, as in the JAX
   package: asserted), tok/s, p50/p99, a profile; (b) two ranks on this card as
   two processes (``--serve-worker``), the lane on gloo (NCCL refuses
   two ranks on one device), each engine on ``cuda:0``, the frontend
   shipping pool-format blocks and rank 1 SIGKILLed at round 6: at f32
   with 2 layers (f32 KV) every request's tokens equal
   ``llama_generate``'s; at the flagship's width in bf16 with int8 KV
   the share equal to (a)'s, each difference with the top-2 logit margin
   of the bf16 forward at its first differing token; (c) the 4 -> 3
   hand-over of the flagship's ZeRO carry (``fused_adam``'s bf16 mu and
   nu) replayed on one card: each survivor's block joined from the
   segments the plan's alltoallv sends it (``alltoallv_splits``, the
   splits ``execute_plan`` uses), bit-exact against ``simulate_plan``,
   ms beside the HBM bound. Across cards:
   ``tests/test_torch_zero_cuda_ranks.py`` (elastic case) and
   ``tests/test_torch_serving_cuda_ranks.py``.
28. The pipeline schedules (``parallel/pipeline.py``) and the last remat
   modes: (a) Llama-3-8B (vocab 128256, d4096, H32/Hkv8, d_ff 14336,
   bf16; 8 of its 32 layers, ``remat="attn+gate"``) at B8 x T2048 as 8
   microbatches over 4 stages, gpipe, ``1f1b`` and ``interleaved_1f1b``
   (V=2) replayed through the in-process transport (every stage on this
   card): each one's loss (1e-2 relative) and every gradient leaf (5e-2
   norm-relative) against the unpipelined ``llama_loss`` on the same
   batch, K1-K3 as the schedule predicts (gpipe L x M each; the fused
   schedules K1 2 L x M, their backward subtick re-running the
   forward), all on wgmma; ms a split step (``fused_adam(3e-4)``) and
   peak GiB of each beside the unpipelined step's; (b)
   ``benchmarks/moe_bench.py``'s MoE (grouped K5/K6, ``remat="moe"``)
   under gpipe and ``1f1b`` at 2 stages x 4 microbatches, each against
   the mean of the unpipelined grad calls on its microbatches (the same
   objective: the aux loss is taken a microbatch) in (a)'s envelope
   (K5 6 L x M under 1f1b, K6's halves 3 L x M each); (c) the
   flagship's split step (B4 x T2048) under ``dots`` (K1 2 L a grad
   call), ``attn+ffn`` and ``attn+gate+qkv`` (K1 L) beside
   ``attn+gate``: ms a step, peak GiB, the loss and gradients
   bit-identical to ``attn+gate``'s. Across cards:
   ``tests/test_torch_pipeline_cuda_ranks.py``.
29. Checkpoints and the data loader (``checkpoint.py``, ``data/``) and
   ``master_weights``: (a) the dense flagship's split step (B4 x T2048,
   ``attn+gate``, ``fused_adam(3e-4)``, full width and depth), its
   batches through an ``AsyncDataLoaderMixin`` loader: 2 steps, an
   async ``CheckpointManager.save`` (``max_to_keep=1``, a temporary
   directory removed at the end), 2 more steps at once (the in-place
   apply runs while the write is in flight), ``wait``, a restore into a
   fresh carry on the card and the same 2 steps again: losses and every
   leaf bit-identical to the uninterrupted run; the save call's blocking
   ms, the flush's s, the bytes (params and both moments in bf16) and
   the restore's s beside the pinned copy rates' bounds; K1-K3 L a step
   and the Adam kernel a leaf a step, on wgmma; (b) the same round trip
   of ``fused_master_adam``'s carry (its f32 master) at the flagship's
   width with 2 layers, then ``master_weights(torch.optim.Adam)`` 3
   steps on that model (the loss backward on ``compute_params``, then
   ``apply``): its ms a step and peak beside the fused split step's.
30. A ``kernels`` JSON line (K1-K6, K1-K3 with their bias cases and
   launches, K1-K3's offsets rows with phase 17's launches, the six
   codec kernels with phase 20 (b)'s, and the Adam kernel's two
   variants with the train paths' launches), the card line, and the
   result line ``{"ok": true, "device": {...}}``.

Weights are random (``torch.Generator`` seeds); nothing is downloaded.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16; f32 FMA


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _kernel_name(mangled):
    """``name<dtype, D>`` (or ``name<dtype, transposed flag>``) of a
    mangled kernel ``_ZN<len><id>...``: the nested identifier ending in
    ``_kernel``, then its template arguments."""
    i = 3
    while m := re.match(r"\d+", mangled[i:]):
        start = i + m.end()
        i = start + int(m.group())
        name = mangled[start:i]
        if name.endswith("_kernel"):
            args = re.match(r"I(13__nv_bfloat16|f)?(?:L([ib])(\d+)E)?",
                            mangled[i:])
            parts = []
            if args and args.group(1):
                parts.append("bf16" if args.group(1) != "f" else "f32")
            if args and args.group(2):
                parts.append(f"D{args.group(3)}" if args.group(2) == "i"
                             else f"transpose_rhs={args.group(3)}")
            return f"{name}<{', '.join(parts)}>" if parts else name
    return "?"


def ptxas_summary(text):
    """One line per compiled kernel from nvcc's -Xptxas=-v output: its
    name with dtype and head dim, registers and spills."""
    out, name, spill = [], "?", ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "Performance Loss" in line:
            out.append(line.split(":", 1)[-1].strip())
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            used = line.split(":", 1)[-1].strip()
            out.append(f"{name}: {used}; {spill}")
            name, spill = "?", ""
    return out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def norm_rel(got, want):
    """|got - want| / |want| in norm, in f32."""
    return float((got.float() - want.float()).norm()) / max(
        float(want.float().norm()), 1e-30)


# Device kernels by kind, from their names: the port's kernels first,
# then cuBLAS/CUTLASS products, then PyTorch's elementwise and reduction
# kernels, then copies.
KERNEL_KINDS = (("K1-K3 flash", ("flash_",)),
                ("K4 decode", ("decode_attention", "namespace)::scores_",
                               "namespace)::pv_", "namespace)::reduce_")),
                ("K5/K6 grouped", ("gmm_",)),
                ("Adam", ("adam_kernel",)),
                ("matmul", ("gemm", "nvjet", "xmma", "cutlass")),
                ("elementwise", ("elementwise",)),
                ("reduction", ("reduce", "norm", "softmax")),
                ("index/scatter", ("index", "scatter", "gather")),
                ("copy", ("Memcpy", "Memset", "copy")))


def kernel_kind(name):
    for kind, marks in KERNEL_KINDS:
        if any(m in name for m in marks):
            return kind
    return "other"


def device_profile(torch, label, fn, top=6):
    """Run ``fn`` under torch.profiler and print the wall time, the
    device's busy time (sum of kernel durations), its idle share, the
    busy time by kind of kernel (:func:`kernel_kind`) and the kernels
    that took the most time. The profiler slows the host, so the idle
    share read here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_kernel.values())
    if not busy_ms:
        log(f"  profile {label}: no device time recorded (not measured)")
        return None
    by_kind = {}
    for name, ms in by_kernel.items():
        kind = kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / wall_ms, by_kind=by_kind,
               top=[(name[:60], ms) for name, ms in sorted(
                   by_kernel.items(), key=lambda kv: -kv[1])[:top]])
    log(f"  profile {label}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {out['idle_share']:.3f}")
    log("    by kind: " + ", ".join(
        f"{kind} {ms:.2f} ms" for kind, ms in sorted(
            by_kind.items(), key=lambda kv: -kv[1])))
    for name, ms in out["top"]:
        log(f"    {ms:9.3f} ms  {name}")
    return out


# ---- phase 2: kernels against their plain versions ---------------------


def wgmma_attrs(_build):
    """The wgmma kernels as the driver loaded them, by the key the cases
    use: registers a thread (ptxas's count at entry; the consumer
    warpgroups raise theirs with setmaxnreg), spilled (local) bytes a
    thread, and shared memory a block (static + dynamic)."""
    import ctypes

    out, buf = {}, (ctypes.c_int * 4)()
    flash = [(f"{k}{' bias' if bias else ''} D{d}", source,
              f"{source}_attrs", (d, bias))
             for k, source in (("K1", "flash_fwd_wgmma"),
                               ("K2", "flash_bwd_wgmma"),
                               ("K3", "flash_bwd_dq_wgmma"))
             for d in (128, 64) for bias in (0, 1)]
    for key, source, entry, args in flash + [
            ("K4 n_rep4 D128", "decode_attention_wgmma",
             "decode_attention_wgmma_attrs", (4, 128)),
            ("K4 n_rep2 D128", "decode_attention_wgmma",
             "decode_attention_wgmma_attrs", (2, 128)),
            ("K5 gmm", "grouped_mm_wgmma", "grouped_wgmma_attrs", (2,)),
            ("K6 dlhs", "grouped_mm_wgmma", "grouped_wgmma_attrs", (0,)),
            ("K6 tgmm", "grouped_mm_wgmma", "grouped_wgmma_attrs", (1,))]:
        fn = getattr(_build.load(source), entry)
        fn.argtypes = [ctypes.c_int] * len(args) + [
            ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        err = fn(*args, buf)
        check(err == 0, f"{entry}{args}: CUDA error {err}")
        out[key] = dict(registers=buf[0], spill_bytes=buf[1],
                        smem_bytes=buf[2] + buf[3])
        log(f"  {key} wgmma kernel: {buf[0]} registers at entry, "
            f"{buf[1]} spill bytes, {buf[2] + buf[3]} bytes shared memory")
    return out


def flash_case(torch, fa, b, t, dtype, iters, attrs, h=16, hkv=4, d=128):
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(b * 1000 + t)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((b, h, t, d), (b, hkv, t, d), (b, hkv, t, d)))
    o, lse = fa._flash_fwd_cuda(q, k, v, True)
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, True)
    torch.cuda.synchronize()
    err = float((o.float() - o_ref.float()).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    route = fa.flash_fwd_route(dtype, d)
    kernel_ms = cuda_ms(torch, lambda: fa._flash_fwd_cuda(q, k, v, True),
                        iters)
    # The FMA kernel on the same bf16 inputs: the wgmma kernel's
    # predecessor (PR 3's route), timed beside it.
    earlier_ms = cuda_ms(torch, lambda: fa._flash_fwd_cuda(
        q, k, v, True, route="fma"), max(1, iters // 2)) \
        if route == "wgmma" else None
    plain_ms = cuda_ms(torch,
                       lambda: fa._flash_fwd_reference(q, k, v, True),
                       max(1, iters // 4), warmup=1)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters)
    # Causal work: each query row attends to itself and the rows before.
    pairs = b * h * t * (t + 1) // 2
    dname = str(dtype).replace("torch.", "")
    bound_ms, bound_by = bound(nbytes(q, k, v, o, lse), 4 * pairs * d,
                               dname)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    name = f"K1 B{b} H{h} Hkv{hkv} T{t} D{d} {dname}"
    tflops = 4 * pairs * d / kernel_ms / 1e9
    kattrs = attrs[f"K1 D{128 if d == 128 else 64}"] \
        if route == "wgmma" else None
    earlier = f", earlier (fma) {earlier_ms:.4f} ms" if earlier_ms else ""
    log(f"  {name}: route {route}, max_abs_err {err:.3e} (tol {tol:g}), "
        f"lse_err {lse_err:.3e} (tol 1e-3), kernel {kernel_ms:.4f} ms "
        f"({tflops:.1f} TFLOP/s){earlier}, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    check(err <= tol, f"{name}: output error {err} above {tol}")
    check(lse_err <= 1e-3, f"{name}: lse error {lse_err} above 1e-3")
    return dict(case=name, kernel_route=route, max_abs_err=err,
                lse_max_abs_err=lse_err, ms=kernel_ms, tflops=tflops,
                earlier_ms=earlier_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                kernel_attrs=kattrs)


def same_bits(torch, fn):
    """Two launches of ``fn`` give the same bits (no atomics, fixed-order
    sums)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return torch.equal(a.view(torch.int16), b.view(torch.int16)) \
        if a.dtype == torch.bfloat16 else torch.equal(a, b)


def bwd_case(torch, fa, b, t, dtype, iters, attrs, h=16, hkv=4, d=128):
    """K2 and K3 against the plain backward on the same q, k, v, do and
    K1's o and lse (causal). Each takes its dtype's route (bf16: wgmma)
    and is timed on the FMA route too (``earlier_ms``); K3 gives the same
    bits on two launches."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(b * 1000 + t + 7)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((b, h, t, d), (b, hkv, t, d),
                                 (b, hkv, t, d), (b, h, t, d)))
    o, lse = fa._flash_fwd_cuda(q, k, v, True)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, True)
    want = fa._flash_bwd_reference(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    abs_err, rel_err = {}, {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        abs_err[name] = float((a.float() - w.float()).abs().max())
        rel_err[name] = abs_err[name] / max(float(w.float().abs().max()),
                                            1e-30)
    delta = fa._delta(o, do)
    route = fa.flash_bwd_route(dtype, d)
    k2_ms = cuda_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
        q, k, v, do, lse, delta, True), iters)
    earlier_ms = cuda_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
        q, k, v, do, lse, delta, True, route="fma"), max(1, iters // 2)) \
        if route == "wgmma" else None
    k3_ms = cuda_ms(torch, lambda: fa._flash_bwd_dq_cuda(
        q, k, v, do, lse, delta, True), iters)
    k3_earlier_ms = cuda_ms(torch, lambda: fa._flash_bwd_dq_cuda(
        q, k, v, do, lse, delta, True, route="fma"), max(1, iters // 2)) \
        if route == "wgmma" else None
    k3_same = same_bits(torch, lambda: fa._flash_bwd_dq_cuda(
        q, k, v, do, lse, delta, True))
    pair_ms = cuda_ms(torch, lambda: fa._flash_bwd_cuda(
        q, k, v, o, lse, do, True), iters)
    plain_ms = cuda_ms(torch, lambda: fa._flash_bwd_reference(
        q, k, v, o, lse, do, True), max(1, iters // 4), warmup=1)
    # Library: SDPA's backward alone, on a saved SDPA forward (the port
    # never calls it).
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                         enable_gqa=True)
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), iters)
    pairs = b * h * t * (t + 1) // 2
    dname = str(dtype).replace("torch.", "")
    reads = nbytes(q, k, v, do, lse, delta)
    # K2 writes dk/dv per query head (got[1], got[2]), K3 writes dq.
    k2_bound, k2_by = bound(reads + nbytes(got[1], got[2]), 8 * d * pairs,
                            dname)
    k3_bound, k3_by = bound(reads + nbytes(got[0]), 6 * d * pairs, dname)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    name = f"B{b} H{h} Hkv{hkv} T{t} D{d} {dname} causal"
    k2_tflops = 8 * d * pairs / k2_ms / 1e9
    k3_tflops = 6 * d * pairs / k3_ms / 1e9
    earlier = f", earlier (fma) {earlier_ms:.4f} ms" if earlier_ms else ""
    k3_earlier = f", earlier (fma) {k3_earlier_ms:.4f} ms" \
        if k3_earlier_ms else ""
    log(f"  K2/K3 {name}: rel err dq {rel_err['dq']:.3e} dk "
        f"{rel_err['dk']:.3e} dv {rel_err['dv']:.3e} (tol {tol:g}, of "
        f"the reference's max abs); K2 route {route} {k2_ms:.4f} ms "
        f"({k2_tflops:.1f} TFLOP/s{earlier}; bound {k2_bound:.4f}"
        f" {k2_by}), K3 route {route} {k3_ms:.4f} ms ({k3_tflops:.1f} "
        f"TFLOP/s{k3_earlier}; bound {k3_bound:.4f} {k3_by}; same bits on "
        f"two launches: {k3_same}), pair {pair_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (SDPA backward) {library_ms:.4f} ms")
    for grad, err in rel_err.items():
        check(err <= tol, f"K2/K3 {name}: {grad} error {err} above {tol}")
    check(k3_same, f"K3 {name}: two launches gave different bits")
    common = dict(plain_ms=plain_ms, library_ms=library_ms, pair_ms=pair_ms)
    return (dict(case=f"K2 {name}", kernel_route=route,
                 max_abs_err=max(abs_err["dk"], abs_err["dv"]),
                 rel_err={k: rel_err[k] for k in ("dk", "dv")}, ms=k2_ms,
                 tflops=k2_tflops, earlier_ms=earlier_ms,
                 bound_ms=k2_bound, bound_by=k2_by,
                 kernel_attrs=attrs[f"K2 D{128 if d == 128 else 64}"]
                 if route == "wgmma" else None, **common),
            dict(case=f"K3 {name}", kernel_route=route,
                 max_abs_err=abs_err["dq"],
                 rel_err={"dq": rel_err["dq"]}, ms=k3_ms,
                 tflops=k3_tflops, earlier_ms=k3_earlier_ms,
                 bound_ms=k3_bound, bound_by=k3_by, same_bits=k3_same,
                 kernel_attrs=attrs[f"K3 D{128 if d == 128 else 64}"]
                 if route == "wgmma" else None, **common))


def device_launches(torch, fn):
    """The CUDA kernels one call of ``fn`` launches, by name, from the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def decode_case(torch, da, b, hkv, n_rep, s, pos, dtype, iters, attrs,
                d=128, one_launch=False):
    """K4 against its plain version: its dtype's route (bf16: wgmma), the
    FMA kernel's time on the same inputs (``earlier_ms``), the device time
    of the kernel and of the library call (the profiler's: at the decode
    shapes a call's host work outlasts its kernel, so the CUDA events time
    the host), the same bits on two launches, and with ``one_launch`` the
    check that a call is one CUDA launch."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(b * 7 + s)
    h = hkv * n_rep
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").to(dtype)
    ck = torch.randn((b, hkv, s, d), generator=g, device="cuda").to(dtype)
    cv = torch.randn((b, hkv, s, d), generator=g, device="cuda").to(dtype)
    route = da.decode_route(dtype, d)
    out = da._decode_attention_cuda(q, ck, cv, pos)
    ref = da._decode_attention_reference(q, ck, cv, pos)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    def kernel():
        return da._decode_attention_cuda(q, ck, cv, pos)

    same = same_bits(torch, kernel)
    kernels = device_launches(torch, kernel)
    kernel_ms = cuda_ms(torch, kernel, iters)
    earlier_ms = cuda_ms(torch, lambda: da._decode_attention_cuda(
        q, ck, cv, pos, route="fma"), max(1, iters // 2)) \
        if route == "wgmma" else None
    plain_ms = cuda_ms(
        torch, lambda: da._decode_attention_reference(q, ck, cv, pos),
        max(1, iters // 4), warmup=1)
    qt = q.transpose(1, 2)                      # [B, H, 1, D]
    kv_k, kv_v = ck[:, :, :pos + 1], cv[:, :, :pos + 1]
    def library():
        return F.scaled_dot_product_attention(qt, kv_k, kv_v,
                                              enable_gqa=True)

    library_ms = cuda_ms(torch, library, iters)

    def dev_ms(fn, what):
        prof = device_profile(torch, f"K4 {what} x{iters}",
                              lambda: [fn() for _ in range(iters)], top=2)
        return prof and prof["device_busy_ms"] / iters

    device_ms = dev_ms(kernel, "kernel")
    library_device_ms = dev_ms(library, "library")
    n_valid = min(pos + 1, s)
    read = 2 * b * hkv * n_valid * d * ck.element_size()
    dname = str(dtype).replace("torch.", "")
    bound_ms, bound_by = bound(read + nbytes(q, out),
                               4 * b * h * n_valid * d, dname)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    name = f"K4 B{b} Hkv{hkv} n_rep{n_rep} S{s} pos{pos} D{d} {dname}"
    plan = da._decode_plan(b * hkv, n_rep, n_valid, *da._card(
        torch.cuda.current_device(), n_rep, d)) if route == "wgmma" else None
    kattrs = attrs[f"K4 n_rep{n_rep} D{d}"] \
        if route == "wgmma" and f"K4 n_rep{n_rep} D{d}" in attrs else None
    def fmt(v):
        return "not measured" if v is None else f"{v:.4f} ms"

    earlier = f", earlier (fma) {earlier_ms:.4f} ms" if earlier_ms else ""
    log(f"  {name}: route {route}"
        f"{f' (cluster, tiles a block, spill) {plan}' if plan else ''}, "
        f"max_abs_err {err:.3e} (tol {tol:g}), same bits on two launches: "
        f"{same}, CUDA launches a call {len(kernels)}, kernel "
        f"{kernel_ms:.4f} ms{earlier}, device {fmt(device_ms)}, plain "
        f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (device "
        f"{fmt(library_device_ms)}), bound {bound_ms:.4f} ms ({bound_by})")
    check(err <= tol, f"{name}: error {err} above {tol}")
    check(same, f"{name}: two launches gave different bits")
    if one_launch:
        check(len(kernels) == 1, f"{name}: a call launched {kernels}, "
              f"expected one kernel")
    return dict(case=name, kernel_route=route, max_abs_err=err,
                same_bits=same, cuda_launches_per_call=len(kernels),
                plan=plan, ms=kernel_ms, earlier_ms=earlier_ms,
                device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=library_device_ms,
                bound_ms=bound_ms, bound_by=bound_by, kernel_attrs=kattrs)


# ---- phases 3-5: the serving path --------------------------------------


def flagship_config(LlamaConfig):
    """The dense flagship of the repo's bench (bench.py _flagship_cfg):
    ~1.43 B parameters, bf16 compute and storage."""
    return LlamaConfig(vocab_size=32768, d_model=2048, n_layers=14,
                       n_heads=16, n_kv_heads=4, d_ff=13312,
                       dtype="bfloat16", remat="attn+gate",
                       param_dtype="bfloat16")


def launch_counters(fa, da, gm, adam):
    """Every kernel wrapper of the main paths, by the name the counts
    use: K1-K6 and the Adam update."""
    return {"K1": fa._flash_fwd_cuda, "K2": fa._flash_bwd_dkv_cuda,
            "K3": fa._flash_bwd_dq_cuda, "K4": da._decode_attention_cuda,
            "K5": gm._gmm_cuda, "K6 dlhs": gm._gmm_dlhs_cuda,
            "K6 tgmm": gm._tgmm_cuda, "Adam": adam._adam_cuda}


# The kernels with a wgmma route for bf16 (and an FMA route for f32).
ROUTED = ("K1", "K2", "K3", "K4", "K5", "K6 dlhs", "K6 tgmm")


def reset_counts(ctr):
    for fn in ctr.values():
        fn.launches = 0
        if hasattr(fn, "bias_launches"):
            fn.bias_launches = 0
            fn.offsets_launches = 0
        for route in getattr(fn, "launches_by_route", ()):
            fn.launches_by_route[route] = 0
        for variant in getattr(fn, "launches_by_variant", ()):
            fn.launches_by_variant[variant] = 0


def check_adam(ctr, path, per_step, steps, variant="adam"):
    """The Adam kernel launched ``per_step`` times a step (one a leaf or
    ZeRO chunk), all of ``variant``, since the counts were reset."""
    fn = ctr["Adam"]
    want = {v: per_step * steps if v == variant else 0
            for v in fn.launches_by_variant}
    check(fn.launches == per_step * steps and
          fn.launches_by_variant == want,
          f"{path}: the Adam kernel launched {fn.launches} times "
          f"({fn.launches_by_variant}) in {steps} steps, expected "
          f"{per_step} {variant} launches a step")


def counts(ctr):
    return {k: fn.launches for k, fn in ctr.items()}


def bias_counts(ctr):
    """K1-K3's launches of their bias variant."""
    return {k: ctr[k].bias_launches for k in ("K1", "K2", "K3")}


def offsets_counts(ctr):
    """K1-K3's launches of their offsets variant (ring steps)."""
    return {k: ctr[k].offsets_launches for k in ("K1", "K2", "K3")}


def check_wgmma_routes(ctr, path):
    """Every launch of the ROUTED kernels since the counts were reset took
    the wgmma route (the main paths run bf16). Returns the counts by
    route."""
    by_route = {k: dict(ctr[k].launches_by_route) for k in ROUTED}
    for k, by in by_route.items():
        check(by["fma"] == 0 and by["wgmma"] == ctr[k].launches,
              f"{path}: {k} launches by route {by}, expected all "
              f"{ctr[k].launches} on wgmma")
    return by_route


def run_generate(torch, ctr, gen, params, cfg, batch, prompt_len,
                 new):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(
        np.int32)
    gen.llama_generate(params, prompt[:, :8], cfg, 2)     # warm-up
    torch.cuda.synchronize()
    reset_counts(ctr)
    t0 = time.perf_counter()
    out = gen.llama_generate(params, prompt, cfg, new)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launched = counts(ctr)
    check_wgmma_routes(ctr, "llama_generate")
    t0 = time.perf_counter()
    first, _, _ = gen.llama_prefill(params, prompt, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = out.cpu().numpy()
    check(out.shape == (batch, prompt_len + new), f"shape {out.shape}")
    check((out[:, :prompt_len] == prompt).all(), "prompt not preserved")
    check(((out >= 0) & (out < cfg.vocab_size)).all(), "token off vocab")
    check((out[:, prompt_len] == first.cpu().numpy()).all(),
          "first token differs from llama_prefill's")
    L = cfg.n_layers
    check(launched["K1"] == L,
          f"K1 launched {launched['K1']} times, expected {L}")
    check(launched["K4"] == L * (new - 1),
          f"K4 launched {launched['K4']} times, expected {L * (new - 1)}")
    step_ms = (total_s - prefill_s) / (new - 1) * 1e3
    param_bytes = sum(nbytes(w) for w in params["layers"].values()) + \
        nbytes(params["lm_head"], params["final_norm"])
    log(f"  llama_generate b{batch} prompt {prompt_len} new {new}: "
        f"{total_s:.3f} s total, prefill {prefill_s * 1e3:.2f} ms, decode "
        f"{step_ms:.3f} ms/step, {batch * new / total_s:.1f} tok/s; "
        f"launches {launched}; weight-stream bound "
        f"{param_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms/step")
    prof = device_profile(
        torch, f"llama_generate b{batch} prompt {prompt_len} new 17",
        lambda: gen.llama_generate(params, prompt, cfg, 17))
    return launched, dict(total_s=total_s, prefill_ms=prefill_s * 1e3,
                          decode_ms_per_step=step_ms,
                          tok_s=batch * new / total_s, profile=prof)


def run_engine(torch, ctr, DecodeEngine, Request, params, cfg):
    rng = np.random.default_rng(1)
    n_req, new = 16, 32
    lens = rng.integers(17, 129, n_req)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(lens)]
    eng = DecodeEngine(params, cfg, block_size=32, n_blocks=128,
                       max_batch=16, max_context=128 + new, device="cuda")
    reset_counts(ctr)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launched = counts(ctr)
    check_wgmma_routes(ctr, "DecodeEngine")
    check(eng.scheduler.evictions == 0, "engine evicted under no pressure")
    check(sorted(done) == list(range(n_req)), "not every request completed")
    for r in reqs:
        toks = done[r.rid]
        check(len(toks) == len(r.prompt) + new, f"request {r.rid} length")
        check(((toks >= 0) & (toks < cfg.vocab_size)).all(),
              f"request {r.rid}: token off vocab")
    check(launched["K1"] == cfg.n_layers * n_req,
          f"K1 launched {launched['K1']} times, expected "
          f"{cfg.n_layers * n_req}")
    log(f"  DecodeEngine {n_req} requests (prompts {int(lens.min())}-"
        f"{int(lens.max())}, {new} new each): {total_s:.3f} s, "
        f"{eng.steps} steps, {n_req * new / total_s:.1f} tok/s; "
        f"launches {launched}")
    small = DecodeEngine(params, cfg, block_size=32, n_blocks=128,
                         max_batch=16, max_context=128 + new, device="cuda")

    def drive_small():
        for r in reqs[:4]:
            small.submit(Request(rid=r.rid, prompt=r.prompt,
                                 max_new_tokens=8))
        small.run_until_idle()

    prof = device_profile(torch, "DecodeEngine 4 requests x 8 new",
                          drive_small)
    return launched, dict(total_s=total_s, steps=eng.steps,
                          tok_s=n_req * new / total_s, profile=prof)


def run_parity(gen, DecodeEngine, poisson_trace, llama_init, torch, cfg):
    c32 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                              param_dtype="float32")
    params = llama_init(c32, torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    eng = DecodeEngine(params, c32, block_size=8, n_blocks=64, max_batch=4,
                       max_context=32, device="cuda")
    trace = poisson_trace(6, 1000.0, seed=5, prompt_len=(4, 12),
                          max_new=(3, 8), vocab_size=c32.vocab_size)
    for r in trace[:3]:
        eng.submit(r)
    for _ in range(2):
        eng.step()
    for r in trace[3:]:
        eng.submit(r)
    done = eng.run_until_idle()
    for r in trace:
        ref = gen.llama_generate(params, r.prompt[None, :], c32,
                                 r.max_new_tokens)[0].cpu().numpy()
        check(np.array_equal(done[r.rid], ref),
              f"request {r.rid}: engine {done[r.rid].tolist()} != "
              f"llama_generate {ref.tolist()}")
    log(f"  f32 parity: {len(trace)} requests, engine tokens == "
        f"llama_generate tokens")


# ---- phases 6-7: the training path -------------------------------------


def logits_case(torch, llama, cfg, tokens):
    """The lm_head product at the train step's shape: the path this
    torch takes (mm with out_dtype=float32, or the f32 upcast), its
    agreement with the f32 product of the upcast operands, and the
    forward and backward times of both."""
    g = torch.Generator(device="cuda").manual_seed(11)
    h = torch.randn((tokens, cfg.d_model), generator=g,
                    device="cuda").bfloat16().requires_grad_(True)
    w = (torch.randn((cfg.d_model, cfg.vocab_size), generator=g,
                     device="cuda") * cfg.d_model ** -0.5).bfloat16()
    out = llama._F32Logits.apply(h, w)
    ref = torch.mm(h.detach().float(), w.float())
    gout = torch.randn_like(out)
    torch.cuda.synchronize()
    err = float((out.detach() - ref).abs().max() / ref.abs().max())
    fwd_ms = cuda_ms(torch, lambda: llama._F32Logits.apply(h.detach(), w),
                     5)
    upcast_ms = cuda_ms(torch, lambda: torch.mm(h.detach().float(),
                                                w.float()), 5)
    bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, h, gout, retain_graph=True), 5)
    path = "mm(out_dtype=float32)" if llama._MM_OUT_DTYPE else \
        "f32 upcast"
    log(f"  lm_head logits [{tokens}, {cfg.d_model}] x [{cfg.d_model}, "
        f"{cfg.vocab_size}]: path {path}, rel err vs f32 upcast {err:.3e} "
        f"(tol 1e-4), forward {fwd_ms:.3f} ms (f32 upcast {upcast_ms:.3f} "
        f"ms), backward (f32 products) {bwd_ms:.3f} ms")
    check(err <= 1e-4, f"lm_head logits error {err} above 1e-4")
    return dict(path=path, rel_err=err, fwd_ms=fwd_ms,
                upcast_fwd_ms=upcast_ms, bwd_ms=bwd_ms)


def run_train(torch, ctr, llama, precision, train_step, cfg, batch,
              seq, steps, card):
    from horovod_tpu_torch.parallel._tree import tree_leaves

    params = llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "lm_head"))
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        batch, seq)).astype(np.int32)).cuda()
    data = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    ts = train_step.make_split_train_step(
        lambda p, d: llama.llama_loss(p, d, cfg), precision.fused_adam(3e-4))
    carry = ts.init(params)
    del params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, carry = ts.step(carry, data)                      # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reset_counts(ctr)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, carry = ts.step(carry, data)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launched = counts(ctr)
    check_wgmma_routes(ctr, "train step")
    check_adam(ctr, "train step", len(tree_leaves(carry[0])), steps)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    L = cfg.n_layers
    for k in ("K1", "K2", "K3"):
        check(launched[k] == L * steps,
              f"{k} launched {launched[k]} times in {steps} steps, "
              f"expected {L} per grad call")
    check(launched["K4"] == launched["K5"] == 0,
          "the dense train step launched K4 or K5")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    tok = batch * seq
    flops_per_token = 6 * n_params + 12 * L * seq * cfg.d_model
    mfu = flops_per_token * tok / dt / PEAK_FLOPS["bfloat16"]
    log(f"  train step B{batch} T{seq} remat={cfg.remat} bf16 fused_adam: "
        f"{dt * 1e3:.1f} ms/step, {tok / dt:.0f} tok/s, MFU {mfu:.4f} "
        f"((6N + 12 L T d) per token at 989 TFLOP/s), peak memory "
        f"{peak / 2**30:.2f} GiB, first step {first_s:.2f} s; losses "
        f"{[round(x, 4) for x in losses]}; launches {launched} (per grad "
        f"call: {L} each); card {card}")
    logits = logits_case(torch, llama, cfg, tok)
    prof = device_profile(torch, f"train step B{batch} T{seq}",
                          lambda: ts.step(carry, data), top=10)
    return launched, dict(ms_per_step=dt * 1e3, tok_s=tok / dt, mfu=mfu,
                          peak_mem_gib=peak / 2**30, first_step_s=first_s,
                          losses=losses, n_params=n_params, logits=logits,
                          profile=prof)


def run_train_parity(torch, ctr, llama, train_step, cfg, expected):
    """f32, 2 layers, B2 T256: the card's loss and gradients against the
    plain CPU path; the remat modes of ``expected`` ({mode: {kernel:
    launches per grad call}}, ``none`` first) against each other on the
    card, each with the launches that show what its backward re-ran."""
    from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map

    c32 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                              param_dtype="float32", remat="none")
    cpu_params = llama.llama_init(c32, torch.Generator().manual_seed(3),
                                  device="cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, c32.vocab_size, (2, 256)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}

    def value_and_grad(params, c, device):
        loss, grads = train_step._value_and_grad(
            lambda p, d: llama.llama_loss(p, d, c, device=device), params,
            batch, 1)
        return float(loss), [g.float().cpu() for g in tree_leaves(grads)]

    t0 = time.perf_counter()
    cpu_loss, cpu_grads = value_and_grad(cpu_params, c32, "cpu")
    cpu_s = time.perf_counter() - t0
    card_params = tree_map(lambda w: w.cuda(), cpu_params)
    del cpu_params
    results, launched = {}, {}
    for mode, want in expected.items():
        reset_counts(ctr)
        results[mode] = value_and_grad(card_params, dataclasses.replace(
            c32, remat=mode), "cuda")
        n = counts(ctr)
        launched[mode] = {k: n[k] for k in want}

    def rel(got, want):
        return max(float((g - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
                   for g, w in zip(got, want))

    loss_err = abs(results["none"][0] - cpu_loss) / abs(cpu_loss)
    grad_err = rel(results["none"][1], cpu_grads)
    mode_err = {m: rel(results[m][1], results["none"][1])
                for m in expected if m != "none"}
    log(f"  f32 train parity (2 layers, B2 T256): card vs CPU loss rel err "
        f"{loss_err:.3e} (tol 1e-5), grads {grad_err:.3e} (tol 2e-4 of "
        f"each leaf's max abs); remat vs none {mode_err} (tol 1e-5); "
        f"launches per grad call {launched}; CPU grad call {cpu_s:.1f} s")
    check(loss_err <= 1e-5, f"card loss differs from CPU by {loss_err}")
    check(grad_err <= 2e-4, f"card grads differ from CPU by {grad_err}")
    for m, e in mode_err.items():
        check(e <= 1e-5, f"remat={m} grads differ from none by {e}")
    check(launched == expected,
          f"launches per remat mode {launched}, expected {expected}")
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_err,
                remat_rel_err=mode_err, launches_per_grad_call=launched,
                cpu_grad_call_s=cpu_s)


# ---- phase 2 (MoE): the grouped matmuls against their plain versions ----


def library_grouped_ms(torch, label, fn, iters):
    """Time one ``torch._grouped_mm`` call (the yardstick: the port never
    calls it), or None where this torch lacks it or refuses the form."""
    if not hasattr(torch, "_grouped_mm"):
        log(f"    library {label}: none (this torch has no _grouped_mm)")
        return None
    try:
        fn()
    except RuntimeError as e:
        log(f"    library {label}: none ({str(e).splitlines()[0][:120]})")
        return None
    return cuda_ms(torch, fn, iters)


def gmm_case(torch, gm, label, sizes, k, n, dtype, iters, attrs,
             backward=True):
    """K5, and with ``backward`` both halves of K6, against the plain
    versions on one routing: ``sizes[e]`` rows of lhs [M, K] for expert e,
    in order. Returns {"K5": case, "K6 dlhs": case, "K6 tgmm": case}."""
    m, e = sum(sizes), len(sizes)
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    lhs = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    rhs = (torch.randn((e, k, n), generator=g, device="cuda")
           * k ** -0.5).to(dtype)
    grad = torch.randn((m, n), generator=g, device="cuda").to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    dname = str(dtype).replace("torch.", "")
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    # The experts this routing reads, and the products its rows need.
    rhs_bytes = nbytes(rhs) * sum(1 for x in sizes if x) // e
    flops = 2 * m * k * n
    bf16 = dtype == torch.bfloat16

    def one(kname, kernel, plain, library, in_bytes, route="fma",
            earlier=None, on_device=False):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        abs_err = float((got.float() - want.float()).abs().max())
        err = abs_err / max(float(want.float().abs().max()), 1e-30)
        ms = cuda_ms(torch, kernel, iters)
        earlier_ms = cuda_ms(torch, earlier, max(1, iters // 2)) \
            if earlier and route == "wgmma" else None
        plain_ms = cuda_ms(torch, plain, max(1, iters // 4), warmup=1)
        lib_ms = library_grouped_ms(torch, f"{kname} {label}", library,
                                    iters) if bf16 else None
        # Small M: the call's host work outlasts its kernels, so the CUDA
        # events above time the host; the profiler gives the device's
        # time (its kernels' durations summed).
        def dev_ms(fn, what):
            prof = device_profile(torch, f"{kname} {label} {what} x{iters}",
                                  lambda: [fn() for _ in range(iters)], top=2)
            return prof and prof["device_busy_ms"] / iters

        dev = dict(device_ms=dev_ms(kernel, "kernel"),
                   library_device_ms=dev_ms(library, "library")
                   if lib_ms is not None else None) if on_device else {}
        moved = in_bytes + nbytes(got)
        bound_ms, bound_by = bound(moved, flops, dname)
        name = f"{kname} {label} M{m} K{k} N{n} E{e} {dname}"
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else \
            "none (torch._grouped_mm takes bf16 only)" if not bf16 else "none"
        earlier_s = f", earlier (fma) {earlier_ms:.4f} ms" \
            if earlier_ms else ""
        if dev:
            ms_s = {k: "not measured" if v is None else f"{v:.4f} ms"
                    for k, v in dev.items()}
            earlier_s += (f", device time {ms_s['device_ms']} (library "
                          f"{ms_s['library_device_ms']})")
        log(f"  {name} groups {sizes}: route {route}, rel err {err:.3e} (tol "
            f"{tol:g}, of the plain version's max abs), kernel {ms:.4f} ms"
            f"{earlier_s}, plain "
            f"{plain_ms:.4f} ms, library {lib}, bound {bound_ms:.4f} ms "
            f"({bound_by}; bytes {moved / HBM_BYTES_PER_S * 1e3:.4f} ms, "
            f"operations {flops / PEAK_FLOPS[dname] * 1e3:.4f} ms at "
            f"{PEAK_FLOPS[dname] / 1e12:.0f} TFLOP/s), "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        check(err <= tol, f"{name}: error {err} above {tol}")
        return dict(case=name, kernel_route=route, max_abs_err=abs_err,
                    rel_err=err, ms=ms, tflops=flops / ms / 1e9,
                    earlier_ms=earlier_ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                    kernel_attrs=attrs.get(kname) if route == "wgmma"
                    else None, **dev)

    route = gm.grouped_route(dtype)
    splits = gm._gmm_split_k(m, k, n, e, gm._sm_count(lhs.device)) \
        if route == "wgmma" else 1
    out = {"K5": one(
        "K5 gmm", lambda: gm._gmm_cuda(lhs, rhs, gs),
        lambda: gm._gmm_reference(lhs, rhs, gs),
        lambda: torch._grouped_mm(lhs, rhs, offs=offs),
        nbytes(lhs) + rhs_bytes, route,
        lambda: gm._gmm_cuda(lhs, rhs, gs, route="fma"),
        on_device=bf16 and m < 1024)}
    out["K5"]["k_splits"] = splits
    if splits > 1:
        log(f"    K5 {label}: contraction in {splits} splits")
        again = gm._gmm_cuda(lhs, rhs, gs)
        check(torch.equal(gm._gmm_cuda(lhs, rhs, gs).view(torch.int16),
                          again.view(torch.int16)),
              f"K5 {label}: split-K result differs between two launches")
    if backward:
        out["K6 dlhs"] = one(
            "K6 dlhs", lambda: gm._gmm_dlhs_cuda(grad, rhs, gs),
            lambda: gm._gmm_dlhs_reference(grad, rhs, gs),
            lambda: torch._grouped_mm(grad, rhs.transpose(-2, -1),
                                      offs=offs),
            nbytes(grad) + rhs_bytes, route,
            lambda: gm._gmm_dlhs_cuda(grad, rhs, gs, route="fma"))
        out["K6 tgmm"] = one(
            "K6 tgmm", lambda: gm._tgmm_cuda(lhs, grad, gs),
            lambda: gm._tgmm_reference(lhs, grad, gs),
            lambda: torch._grouped_mm(lhs.t(), grad, offs=offs),
            nbytes(lhs, grad), route,
            lambda: gm._tgmm_cuda(lhs, grad, gs, route="fma"))
        if 0 in sizes:
            empty = gm._tgmm_cuda(lhs, grad, gs)[
                torch.tensor(sizes, device="cuda") == 0]
            check(not bool(empty.any()), f"K6 tgmm {label}: an empty "
                  f"group's slice is not exactly 0")
    return out


# ---- phases 8-10: the sparse-MoE model ---------------------------------


def moe_config(LlamaConfig):
    """The repo's sparse-MoE bench config (benchmarks/moe_bench.py:47
    _moe_cfg): vocab 32768, d2048, L12, H16/Hkv8, d_ff 4096, 4 experts
    top-2, bf16 compute and storage, remat="moe"; 1.494 B parameters,
    0.889 B active."""
    return LlamaConfig(vocab_size=32768, d_model=2048, n_layers=12,
                       n_heads=16, n_kv_heads=8, d_ff=4096, n_experts=4,
                       n_experts_per_token=2, dtype="bfloat16", remat="moe",
                       param_dtype="bfloat16", scan_unroll=12)


def param_counts(params, cfg):
    """(total, active): the total minus the (E-K)/E share of expert
    weights a token never touches (moe_bench.py:67 _active_params)."""
    leaves = list(params["layers"].values()) + [
        params[k] for k in ("embed", "final_norm", "lm_head")]
    total = sum(w.numel() for w in leaves)
    expert = sum(w.numel() for name, w in params["layers"].items()
                 if name.startswith("moe_"))
    inactive = expert * (cfg.n_experts - cfg.n_experts_per_token) \
        // cfg.n_experts
    return total, total - inactive


def moe_ffn_without_host_sync(torch, gm, cfg, tokens):
    """One MoE layer's grouped FFN, forward and backward, at the model's
    width under torch's sync debug mode "error": any wait on the host
    (a read of group_sizes, bincount, one_hot) raises and fails the
    smoke. The mode is a prototype that may miss some syncs."""
    g = torch.Generator(device="cuda").manual_seed(9)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def w(shape, fan_in):
        return (torch.randn(shape, generator=g, device="cuda")
                * fan_in ** -0.5).to(cfg.compute_dtype).requires_grad_(True)

    lp = {"router": w((d, e), d), "moe_gate": w((e, d, f), d),
          "moe_up": w((e, d, f), d), "moe_down": w((e, f, d), f)}
    h = torch.randn((1, tokens, d), generator=g, device="cuda").to(
        cfg.compute_dtype).requires_grad_(True)

    def run():
        y, aux = gm.grouped_moe_ffn(h, lp, cfg)
        return torch.autograd.grad(y.float().sum() + aux, [h, *lp.values()])

    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"  grouped_moe_ffn forward + backward, {tokens} tokens at d{d} "
        f"E{e}: no host sync (torch sync debug mode 'error')")


def run_moe_train(torch, ctr, llama, precision, train_step, cfg, batch, seq,
                  steps, card):
    """moe_bench.py's step: split step, fused Adam, 2 microbatches."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    params = llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    total, active = param_counts(params, cfg)
    log(f"  MoE: {total / 1e9:.3f} B params, {active / 1e9:.3f} B active, "
        f"{total * 2 / 1e9:.2f} GB bf16")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        batch, seq)).astype(np.int32)).cuda()
    data = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    micro = 2
    ts = train_step.make_split_train_step(
        lambda p, d: llama.llama_loss(p, d, cfg), precision.fused_adam(3e-4),
        microbatches=micro)
    carry = ts.init(params)
    del params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, carry = ts.step(carry, data)                      # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reset_counts(ctr)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, carry = ts.step(carry, data)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launched = counts(ctr)
    check_wgmma_routes(ctr, "MoE train step")
    check_adam(ctr, "MoE train step", len(tree_leaves(carry[0])), steps)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    L = cfg.n_layers
    per_call = {"K1": L, "K2": L, "K3": L, "K4": 0, "K5": 3 * L,
                "K6 dlhs": 3 * L, "K6 tgmm": 3 * L}
    grad_calls = steps * micro
    for k, n in per_call.items():
        check(launched[k] == n * grad_calls,
              f"{k} launched {launched[k]} times in {grad_calls} grad "
              f"calls, expected {n} per grad call")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    tok = batch * seq
    flops_per_token = 6 * active + 12 * L * seq * cfg.d_model
    mfu = flops_per_token * tok / dt / PEAK_FLOPS["bfloat16"]
    log(f"  MoE train step B{batch} T{seq} remat={cfg.remat} {micro} "
        f"microbatches bf16 fused_adam: {dt * 1e3:.1f} ms/step, "
        f"{tok / dt:.0f} tok/s, active-parameter MFU {mfu:.4f} ((6 N_active "
        f"+ 12 L T d) per token at 989 TFLOP/s), peak memory "
        f"{peak / 2**30:.2f} GiB, first step {first_s:.2f} s; losses "
        f"{[round(x, 4) for x in losses]}; launches {launched} (per grad "
        f"call: {per_call}); card {card}")
    prof = device_profile(torch, f"MoE train step B{batch} T{seq}",
                          lambda: ts.step(carry, data), top=10)
    return launched, dict(ms_per_step=dt * 1e3, tok_s=tok / dt, mfu=mfu,
                          peak_mem_gib=peak / 2**30, first_step_s=first_s,
                          losses=losses, n_params=total,
                          n_active_params=active, profile=prof)


def run_moe_generate(torch, ctr, gen, params, cfg):
    """llama_generate b16 (grouped decode FFN, K5) and b1 (the top-K
    gather, no K5 after prefill)."""
    L, new = cfg.n_layers, 16
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, (16, 128)).astype(np.int32)
    gen.llama_generate(params, prompt[:, :8], cfg, 2)     # warm-up
    torch.cuda.synchronize()
    reset_counts(ctr)
    t0 = time.perf_counter()
    out = gen.llama_generate(params, prompt, cfg, new)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launched = counts(ctr)
    check_wgmma_routes(ctr, "MoE llama_generate")
    t0 = time.perf_counter()
    first, _, _ = gen.llama_prefill(params, prompt, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = out.cpu().numpy()
    check(out.shape == (16, 128 + new), f"shape {out.shape}")
    check((out[:, :128] == prompt).all(), "prompt not preserved")
    check(((out >= 0) & (out < cfg.vocab_size)).all(), "token off vocab")
    check((out[:, 128] == first.cpu().numpy()).all(),
          "first token differs from llama_prefill's")
    want = {"K1": L, "K4": L * (new - 1), "K5": 3 * L * new, "K6 dlhs": 0,
            "K6 tgmm": 0}
    for k, n in want.items():
        check(launched[k] == n, f"MoE llama_generate b16: {k} launched "
              f"{launched[k]} times, expected {n} (K5 3 per layer in "
              f"prefill and in each decode step)")
    step_ms = (total_s - prefill_s) / (new - 1) * 1e3
    log(f"  MoE llama_generate b16 prompt 128 new {new}: {total_s:.3f} s "
        f"total, prefill {prefill_s * 1e3:.2f} ms, decode {step_ms:.3f} "
        f"ms/step, {16 * new / total_s:.1f} tok/s; launches {launched}")
    reset_counts(ctr)
    one = gen.llama_generate(params, prompt[:1, :32], cfg, 8)
    torch.cuda.synchronize()
    n1 = counts(ctr)
    check(one.shape == (1, 40), f"b1 shape {tuple(one.shape)}")
    check(n1["K5"] == 3 * L and n1["K4"] == 7 * L,
          f"MoE llama_generate b1: K5 {n1['K5']} (expected {3 * L}, prefill "
          f"only: B*K < E decodes by the top-K gather), K4 {n1['K4']}")
    log(f"  MoE llama_generate b1 prompt 32 new 8: launches {n1} (decode by "
        f"the top-K weight gather, no K5)")
    prof = device_profile(torch, "MoE llama_generate b16 prompt 128 new 9",
                          lambda: gen.llama_generate(params, prompt, cfg, 9))
    return launched, dict(total_s=total_s, prefill_ms=prefill_s * 1e3,
                          decode_ms_per_step=step_ms,
                          tok_s=16 * new / total_s, b1_launches=n1,
                          profile=prof)


def run_moe_engine(torch, ctr, DecodeEngine, Request, params, cfg):
    """8 requests arriving at once in an engine of max_batch 8 (its
    decode batch is padded to 8 rows: the grouped FFN, K5), then 2 in an
    engine of max_batch 1 (the top-K gather)."""
    L, n_req, new = cfg.n_layers, 8, 16
    rng = np.random.default_rng(7)
    lens = rng.integers(17, 129, n_req)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(lens)]
    eng = DecodeEngine(params, cfg, block_size=32, n_blocks=64, max_batch=8,
                       max_context=128 + new, device="cuda")
    reset_counts(ctr)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launched = counts(ctr)
    check_wgmma_routes(ctr, "MoE DecodeEngine")
    check(sorted(done) == list(range(n_req)), "not every request completed")
    for r in reqs:
        toks = done[r.rid]
        check(len(toks) == len(r.prompt) + new, f"request {r.rid} length")
        check(((toks >= 0) & (toks < cfg.vocab_size)).all(),
              f"request {r.rid}: token off vocab")
    check(launched["K1"] == L * n_req,
          f"K1 launched {launched['K1']} times, expected {L * n_req}")
    check(launched["K5"] == 3 * L * (n_req + eng.steps),
          f"K5 launched {launched['K5']} times, expected 3 per layer per "
          f"prefill and per decode step ({3 * L * (n_req + eng.steps)})")
    log(f"  MoE DecodeEngine {n_req} requests (prompts {int(lens.min())}-"
        f"{int(lens.max())}, {new} new each), max_batch 8: {total_s:.3f} s, "
        f"{eng.steps} steps, {n_req * new / total_s:.1f} tok/s; launches "
        f"{launched}")
    small = DecodeEngine(params, cfg, block_size=32, n_blocks=16,
                         max_batch=1, max_context=128 + new, device="cuda")
    reset_counts(ctr)
    for r in reqs[:2]:
        small.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=8))
    done_small = small.run_until_idle()
    torch.cuda.synchronize()
    n1 = counts(ctr)
    check(sorted(done_small) == [0, 1], "max_batch 1: not every request "
          "completed")
    check(n1["K5"] == 3 * L * 2, f"max_batch 1: K5 launched {n1['K5']} "
          f"times, expected {3 * L * 2} (prefills only)")
    log(f"  MoE DecodeEngine 2 requests x 8 new, max_batch 1: {small.steps} "
        f"steps; launches {n1} (decode by the top-K gather)")
    return launched, dict(total_s=total_s, steps=eng.steps,
                          tok_s=n_req * new / total_s,
                          max_batch_1_launches=n1)


def bf16_grad_agreement(torch, ctr, fa, value_and_grad, cpu_params, want,
                        label):
    """One bf16 grad call on the card, where the routed kernels take the
    wgmma route, against the same call in bf16 on the CPU, where every op
    takes its plain version. ``value_and_grad(params, device)`` returns
    (loss, [gradient leaves]); ``want`` the launches the card call must
    make.

    bf16 gradients are chaotic at the last bit: changing only how K1's
    output rounds (its plain version fed f64 inputs, which skips the bf16
    rounding of p and so moves o by about one bf16 ulp, as a correct
    kernel summing in another order may) moves each leaf by several
    percent in norm, and the card changes the rounding of every op
    (cuBLAS products, norms, K1-K6). So each leaf is held, in norm, to 2x
    its own floor (that K1-rounding change, measured here on the CPU) plus
    1e-2; the loss to 2e-3 relative. A wrong kernel (a mask, a bias, a
    group boundary, a transposed tile) moves the gradients by a large
    fraction of their norm."""
    from horovod_tpu_torch.parallel._tree import tree_map

    def norm_rels(got, want):
        return [norm_rel(g, w) for g, w in zip(got, want)]

    t0 = time.perf_counter()
    cpu_loss, cpu_grads = value_and_grad(cpu_params, "cpu")
    cpu_s = time.perf_counter() - t0
    plain_k1 = fa._flash_fwd_reference

    def k1_unrounded_p(q, k, v, causal=True, kv_bias=None, offsets=None):
        o, lse = plain_k1(q.double(), k.double(), v.double(), causal,
                          kv_bias, offsets)
        return o.to(q.dtype), lse.float()

    fa._flash_fwd_reference = k1_unrounded_p
    try:
        _, f64_grads = value_and_grad(cpu_params, "cpu")
    finally:
        fa._flash_fwd_reference = plain_k1
    floor = norm_rels(f64_grads, cpu_grads)
    card_params = tree_map(lambda w: w.cuda(), cpu_params)
    reset_counts(ctr)
    loss, grads = value_and_grad(card_params, "cuda")
    by_route = check_wgmma_routes(ctr, label)
    launched = counts(ctr)
    loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
    err = norm_rels(grads, cpu_grads)
    ratio = max(e / (2 * f + 1e-2) for e, f in zip(err, floor))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    log(f"  {label}: card (wgmma) vs CPU (plain) loss {loss:.5f} vs "
        f"{cpu_loss:.5f}, rel err {loss_err:.3e} (tol 2e-3); grads, "
        f"norm-relative per leaf: card {[round(e, 4) for e in err]}, CPU "
        f"floor (K1 without p's bf16 rounding) "
        f"{[round(f, 4) for f in floor]}, worst leaf at {ratio:.3f} of its "
        f"tolerance (2 x floor + 1e-2); launches {launched}, by route "
        f"{by_route}; CPU grad call {cpu_s:.1f} s")
    check(finite, f"{label}: non-finite bf16 gradient on the card")
    check({k: launched[k] for k in want} == want,
          f"{label}: launches {launched}, expected {want}")
    check(loss_err <= 2e-3, f"{label}: card loss differs from CPU by "
          f"{loss_err}")
    check(ratio <= 1.0, f"{label}: card grads differ from CPU beyond 2 x "
          f"the rounding floor + 1e-2: {err} vs floor {floor}")
    return dict(loss_rel_err=loss_err, grad_norm_rel_err=err,
                grad_floor=floor, worst_ratio=ratio, launches=launched,
                launches_by_route=by_route, cpu_grad_call_s=cpu_s)


def run_bf16_grad_check(torch, ctr, fa, llama, train_step, cfg):
    """The MoE model at 2 layers and bf16 (B2 T256, remat "none") through
    :func:`bf16_grad_agreement`: K1, K2, K5 and K6 on wgmma on the
    card."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    c16 = dataclasses.replace(cfg, n_layers=2, remat="none")
    cpu_params = llama.llama_init(c16, torch.Generator().manual_seed(8),
                                  device="cpu")
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, c16.vocab_size, (2, 256)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}

    def value_and_grad(params, device):
        loss, grads = train_step._value_and_grad(
            lambda p, d: llama.llama_loss(p, d, c16, device=device), params,
            batch, 1)
        return float(loss), [g.float().cpu() for g in tree_leaves(grads)]

    return bf16_grad_agreement(
        torch, ctr, fa, value_and_grad, cpu_params,
        {"K1": 2, "K2": 2, "K5": 6, "K6 dlhs": 6, "K6 tgmm": 6},
        "bf16 MoE grad call (2 layers, B2 T256)")


# ---- phase 11: the Horovod eager lane on NCCL ---------------------------


def raises(exc, fn):
    """Whether ``fn()`` raises ``exc`` (an expected refusal)."""
    try:
        fn()
    except exc:
        return True
    return False


def lane_expected(torch, x):
    """A world of one with prescale 2 and postscale 0.25: a float result
    is exactly x / 2 (powers of two round exactly), an integer one
    trunc(x * 2 * 0.25)."""
    if x.dtype.is_floating_point:
        return x * 0.5
    return torch.trunc(x.double() * 2 * 0.25).to(x.dtype)


def lane_responses(hvd):
    """CUDA responses run so far, by the lane's metrics registry."""
    return sum(c["responses"] for c in hvd.metrics()["device_ops"].values())


def lane_ops(torch, hvd, rt):
    """Every op of the frontend on CUDA tensors, each against its value
    at world size 1; every response one NCCL call, none on gloo."""
    dp = rt.data_plane
    dp.reset_counts()
    before = lane_responses(hvd)
    n = 0

    def same(got, want, what):
        nonlocal n
        check(got.is_cuda and got.device == want.device,
              f"lane {what}: result on {got.device}")
        check(got.dtype == want.dtype and got.shape == want.shape and
              torch.equal(got, want), f"lane {what}: wrong values")
        n += 1

    kw = dict(prescale_factor=2.0, postscale_factor=0.25)
    for d, dtype in enumerate((torch.float32, torch.bfloat16,
                               torch.float16, torch.int32)):
        n_before = n
        g = torch.Generator(device="cuda").manual_seed(d)
        if dtype.is_floating_point:
            x = torch.randn((257, 33), generator=g, device="cuda").to(dtype)
        else:
            x = torch.randint(-99, 100, (257, 33), generator=g,
                              device="cuda", dtype=dtype)
        half = lane_expected(torch, x)
        ops = ("Sum", "Average", "Min", "Max", "Product") + (
            ("Adasum",) if dtype.is_floating_point else ())
        for op in ops:
            same(hvd.allreduce(x, op=getattr(hvd, op), **kw), half,
                 f"allreduce {op} {dtype}")
            y = x.clone()
            ptr = y.data_ptr()
            hvd.allreduce_(y, op=getattr(hvd, op), **kw)
            check(y.data_ptr() == ptr, "allreduce_ moved its storage")
            same(y, half, f"allreduce_ {op} {dtype}")
        xs = [x, x[:100], x[7:9]]
        for got, t in zip(hvd.grouped_allreduce(xs, op=hvd.Average, **kw),
                          xs):
            same(got, lane_expected(torch, t), f"grouped_allreduce {dtype}")
        ys = [t.clone() for t in xs]
        hvd.grouped_allreduce_(ys, op=hvd.Sum, **kw)
        for t, y in zip(xs, ys):
            same(y, lane_expected(torch, t), f"grouped_allreduce_ {dtype}")
        same(hvd.allgather(x), x, f"allgather {dtype}")
        for got, t in zip(hvd.grouped_allgather([x, x[:5]]), [x, x[:5]]):
            same(got, t, f"grouped_allgather {dtype}")
        same(hvd.broadcast(x, root_rank=0), x, f"broadcast {dtype}")
        y = x.clone()
        hvd.broadcast_(y, root_rank=0)
        same(y, x, f"broadcast_ {dtype}")
        same(hvd.alltoall(x, splits=[257]), x, f"alltoall {dtype}")
        same(hvd.reducescatter(x, op=hvd.Average, **kw), half,
             f"reducescatter {dtype}")
        for got, t in zip(hvd.grouped_reducescatter([x, x[:3]], op=hvd.Max),
                          [x, x[:3]]):
            same(got, t, f"grouped_reducescatter {dtype}")
        log(f"  {str(dtype).removeprefix('torch.')}: allreduce and "
            f"allreduce_ {'/'.join(ops)}, grouped_allreduce(_), allgather, "
            f"grouped_allgather, broadcast(_), alltoall, reducescatter, "
            f"grouped_reducescatter: {n - n_before} results equal to their "
            f"values")
    torch.cuda.synchronize()
    responses = lane_responses(hvd) - before
    launches = dict(dp.launches)
    check(launches.get("gloo", 0) == 0,
          f"lane ops: a CUDA op went through gloo: {launches}")
    check(launches.get("nccl", 0) == responses,
          f"lane ops: {launches} NCCL calls for {responses} responses")
    by_op = {f"{b}:{o}": c for (b, o), c in sorted(dp.by_op.items())}
    log(f"  ops: {n} results on the card, each equal to its value at "
        f"world size 1 (f32, bf16, f16, int32; Sum/Average/Min/Max/Product/"
        f"Adasum; prescale 2, postscale 0.25; in place and out of place; "
        f"grouped and single); {responses} responses, {launches['nccl']} "
        f"NCCL calls, 0 gloo: {by_op}")
    return dict(checks=n, responses=responses, calls=by_op)


def lane_stream_order(torch, hvd, rt):
    """A tensor written on a side stream behind a ~0.5 s kernel: the
    lane must wait for the write (its event wait), and, as a control,
    reads the stale zeros when that wait is switched off."""
    def produce_then_reduce():
        x = torch.zeros(1 << 20, device="cuda")
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            torch.cuda._sleep(int(1e9))
            x.fill_(3.0)
            out = hvd.allreduce_async(x, op=hvd.Sum).synchronize()
            got = out.cpu()
        return got

    got = produce_then_reduce()
    check(bool((got == 3.0).all()), f"lane read a side-stream tensor before "
          f"its producer wrote it: {got.unique()}")
    rt.data_plane.wait_for_producers = False
    try:
        stale = produce_then_reduce()
    finally:
        rt.data_plane.wait_for_producers = True
    check(not bool((stale == 3.0).all()),
          "control: without the lane's wait on the producer's event the "
          "result still held the producer's value, so the ordering check "
          "could not catch a missing wait")
    log(f"  stream order (timeline on): side-stream producer behind a "
        f"~0.5 s kernel read after its write (3.0); without the event wait "
        f"the lane reads {sorted(set(stale.unique().tolist()))} (stale)")
    return dict(ordered=True, timeline=True, stale_without_wait=sorted(
        set(stale.unique().tolist())))


def lane_gradients(torch, hvd, rt, llama, train_step, cfg, card):
    """broadcast_parameters over the flagship's params; the bf16
    gradients of one backward and a copy of them."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    dp = rt.data_plane
    params = llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    leaves = tree_leaves(params)
    before = [p.clone() for p in leaves]
    dp.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hvd.broadcast_parameters(params, root_rank=0)
    torch.cuda.synchronize()
    bcast_ms = (time.perf_counter() - t0) * 1e3
    pbytes = sum(p.nbytes for p in leaves)
    check(all(torch.equal(p, b) for p, b in zip(leaves, before)),
          "broadcast_parameters changed a parameter at world size 1")
    check(dp.launches == {"nccl": len(leaves)},
          f"broadcast_parameters: {dict(dp.launches)} calls for "
          f"{len(leaves)} leaves")
    log(f"  broadcast_parameters: {len(leaves)} leaves, {pbytes / 1e9:.3f} "
        f"GB, {bcast_ms:.2f} ms through NCCL; card {card}")
    del before

    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        4, 2048)).astype(np.int32)).cuda()
    data = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    _, grads = train_step._value_and_grad(
        lambda p, d: llama.llama_loss(p, d, cfg), params, data, 1)
    grads = tree_leaves(grads)
    del params, leaves
    torch.cuda.empty_cache()
    return grads, [g.clone() for g in grads], dict(
        broadcast_ms=bcast_ms, broadcast_bytes=pbytes,
        grad_bytes=sum(g.nbytes for g in grads), leaves=len(grads))


def lane_set_fns(torch, hvd, grads):
    """One gradient set through the lane: as one atomic group, and per
    leaf as ``DistributedOptimizer`` sends it."""
    def grouped():
        hvd.grouped_allreduce_(grads, op=hvd.Average)
        torch.cuda.synchronize()

    def per_leaf():
        hs = [hvd.allreduce_async_(g, name=f"grad.{i}")
              for i, g in enumerate(grads)]
        for h in hs:
            h.synchronize()
        torch.cuda.synchronize()

    return {"grouped_allreduce_": grouped,
            "per-leaf allreduce_async_": per_leaf}


def lane_sets(torch, hvd, rt, grads, want, card, cache, sets=13):
    """Each shape of the gradient set ``sets`` times (the first checked
    alone): bit for bit, responses per set, ms per set, the lane's host
    time per active cycle and per response, and the response cache's
    counts; with the cache on, the per-leaf shape must miss once per
    leaf and hit every leaf of every later set."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.metrics import REGISTRY

    dp = rt.data_plane
    out = {}
    for label, fn in lane_set_fns(torch, hvd, grads).items():
        c0 = basics.response_cache_stats()
        m0 = hvd.metrics()
        dp.reset_counts()
        per_set, times = [], []
        neg0 = (REGISTRY.negotiation_us.sum, REGISTRY.negotiation_us.count)
        exe0 = (REGISTRY.execute_us.sum, REGISTRY.execute_us.count)
        for k in range(sets):
            r0 = lane_responses(hvd)
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            per_set.append(lane_responses(hvd) - r0)
            if k == 0:
                moved, launches = dp.bytes_moved, dict(dp.launches)
                check(launches == {"nccl": per_set[0]},
                      f"lane {label}: {launches} calls for {per_set[0]} "
                      "responses")
        check(all(torch.equal(g.view(torch.int16), w.view(torch.int16))
                  for g, w in zip(grads, want)),
              f"lane {label} (cache {cache}): Average at world size 1 "
              "changed a gradient")
        c1 = basics.response_cache_stats()
        m1 = hvd.metrics()
        hits, misses = c1[0] - c0[0], c1[1] - c0[1]
        leaves = len(grads)
        gbytes = sum(g.nbytes for g in grads)
        dev0 = m0["device_ops"].get("allreduce", {})
        dev1 = m1["device_ops"]["allreduce"]
        dev = {k: dev1[k] - dev0.get(k, 0)
               for k in ("responses", "tensors", "bytes")}
        check(dev == {"responses": sum(per_set), "tensors": sets * leaves,
                      "bytes": sets * gbytes},
              f"lane {label}: device_ops {dev} for {sets} sets of {leaves} "
              f"leaves, {gbytes} bytes, {sum(per_set)} responses")
        # A group never rides the cache; a lookup that does not hit
        # counts as a miss, with the cache off too.
        rides = label.startswith("per-leaf") and cache == "on"
        check((hits, misses) == ((leaves * (sets - 1), leaves) if rides
                                 else (0, leaves * sets)),
              f"lane {label} (cache {cache}): {hits} cache hits, {misses} "
              f"misses over {sets} sets of {leaves} leaves")
        neg = ((REGISTRY.negotiation_us.sum - neg0[0]) / 1e3,
               REGISTRY.negotiation_us.count - neg0[1])
        exe = ((REGISTRY.execute_us.sum - exe0[0]) / 1e3,
               REGISTRY.execute_us.count - exe0[1])
        steady = times[3:]
        ms = float(np.median(steady))
        prof = device_profile(torch, f"lane {label} (cache {cache})", fn) \
            if cache == "on" else None
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        common = max(set(per_set[1:]), key=per_set[1:].count)
        log(f"  cache {cache}: {label} of {leaves} bf16 gradient leaves "
            f"({gbytes / 1e9:.3f} GB), Average: bit for bit; responses per "
            f"set {per_set[0]} (first), {common} (most later sets; all "
            f"{sorted(set(per_set))}); {ms:.3f} ms per gradient set (median "
            f"of {len(steady)}, spread {min(steady):.3f}-{max(steady):.3f}); "
            f"the lane moves {moved / 1e9:.3f} GB a set: bound "
            f"{bound_ms:.3f} ms at 3.35 TB/s; host {neg[0] / neg[1]:.3f} ms "
            f"negotiating per active cycle ({neg[1]} cycles), "
            f"{exe[0] / max(exe[1], 1):.3f} ms queuing per response; cache "
            f"{hits} hits, {misses} misses; device_ops allreduce {dev}; "
            f"card {card}")
        out[label] = dict(
            ms=ms, times_ms=times, responses_first=per_set[0],
            responses_steady=common, responses_per_set=per_set,
            bytes_moved=moved, bound_ms=bound_ms, cache_hits=hits,
            cache_misses=misses, active_cycles=neg[1],
            negotiate_ms_per_cycle=neg[0] / neg[1],
            execute_ms_per_response=exe[0] / max(exe[1], 1),
            device_ops=dev,
            idle_share=None if prof is None else prof["idle_share"],
            profile=prof)
    return out


def lane_timeline(torch, hvd, grads, card, sets=10):
    """One per-leaf set under a timeline: every gradient negotiates and
    runs one NCCL allreduce; then ms per set with the timeline on."""
    from horovod_tpu_torch.common import basics

    fn = lane_set_fns(torch, hvd, grads)["per-leaf allreduce_async_"]
    path = "build/lane_timeline.json"
    os.makedirs("build", exist_ok=True)
    hvd.start_timeline(path)
    try:
        fn()
        basics.lane().timeline.flush()
        with open(path) as f:
            trace = json.load(f)
        check(trace[0]["name"] == "CLOCK_SYNC",
              f"timeline opens with {trace[0]}")
        states = {}
        for ev in trace:
            tensor = ev.get("args", {}).get("tensor")
            if tensor is not None:
                states.setdefault(tensor, []).append((ev["ph"], ev["name"]))
        for i in range(len(grads)):
            got = states.get(f"grad.{i}", [])
            check(("B", "NEGOTIATE") in got and ("E", "NEGOTIATE") in got
                  and ("B", "NCCL_ALLREDUCE") in got and got[-1] ==
                  ("i", "DONE"), f"timeline of grad.{i}: {got}")
        times = []
        for _ in range(sets):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        hvd.stop_timeline()
    ms = float(np.median(times[2:]))
    log(f"  timeline: one per-leaf set, {len(trace)} events; every "
        f"gradient has NEGOTIATE and NCCL_ALLREDUCE then DONE; with the "
        f"timeline on {ms:.3f} ms per set (median of {len(times) - 2}, "
        f"spread {min(times[2:]):.3f}-{max(times[2:]):.3f}); card {card}")
    return dict(events=len(trace), ms=ms, times_ms=times)


def lane_debug_port(hvd):
    """GET /healthz and /metrics of the debug server while the lane
    runs on the card."""
    import urllib.request

    port = hvd.debug_port()
    check(isinstance(port, int) and port > 0, f"debug_port() is {port}")
    got = {}
    for path in ("/healthz", "/metrics"):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            got[path] = (r.status, r.read().decode())
    health = json.loads(got["/healthz"][1])
    check(got["/healthz"][0] == got["/metrics"][0] == 200 and
          health["initialized"] and health["debug_port"] == port,
          f"debug server: {got['/healthz']}")
    check('hvdtpu_op_bytes_total{op="allreduce",plane="device"' in
          got["/metrics"][1], "debug server /metrics lacks device bytes")
    log(f"  debug server on port {port}: /healthz 200 ({health}), "
        f"/metrics 200 ({len(got['/metrics'][1].splitlines())} lines)")
    return dict(port=port, healthz=health)


def lane_sync_bn(torch, hvd, card):
    """SyncBatchNorm's function (the lane's allreduces, NCCL at world
    size 1) against nn.BatchNorm2d on a ResNet-50 activation: forward,
    backward and running statistics, f32 then bf16; both times."""
    from horovod_tpu_torch.torch.sync_batch_norm import _SyncBatchNormFn

    out = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        g = torch.Generator(device="cuda").manual_seed(7)
        x = (torch.randn((32, 256, 56, 56), generator=g, device="cuda")
             * 2 + 0.5).to(dtype)
        dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
        ref = torch.nn.BatchNorm2d(256).cuda().to(dtype)
        with torch.no_grad():
            ref.weight.normal_(1.0, 0.1, generator=g)
            ref.bias.normal_(0.0, 0.1, generator=g)
        weight = ref.weight.detach().clone().requires_grad_(True)
        bias = ref.bias.detach().clone().requires_grad_(True)
        rmean, rvar = ref.running_mean.clone(), ref.running_var.clone()
        n0 = lane_responses(hvd)

        def sync():
            xi = x.detach().requires_grad_(True)
            y = _SyncBatchNormFn.apply(xi, weight, bias, rmean, rvar, 1e-5,
                                       0.1, True, "resnet")
            y.backward(dy)
            return y, xi.grad

        def plain():
            xi = x.detach().requires_grad_(True)
            y = ref(xi)
            y.backward(dy)
            return y, xi.grad

        y, dx = sync()
        yr, dxr = plain()
        check(lane_responses(hvd) - n0 == 2, "SyncBatchNorm: not two lane "
              "allreduces (forward statistics, backward sums)")
        err = {}
        for name, a, b in (("y", y, yr), ("dx", dx, dxr),
                           ("dweight", weight.grad, ref.weight.grad),
                           ("dbias", bias.grad, ref.bias.grad),
                           ("running_mean", rmean, ref.running_mean),
                           ("running_var", rvar, ref.running_var)):
            a, b = a.float(), b.float()
            scale = max(b.abs().max().item(), 1.0)
            err[name] = (a - b).abs().max().item() / scale
            check(torch.isfinite(a).all() and err[name] < tol,
                  f"SyncBatchNorm {dtype} {name}: error {err[name]:.3e} of "
                  f"the plain version's max (tol {tol})")
        ms = cuda_ms(torch, sync, 10)
        plain_ms = cuda_ms(torch, plain, 10)
        name = str(dtype).removeprefix("torch.")
        log(f"  SyncBatchNorm [32, 256, 56, 56] {name}: forward + backward "
            f"through the lane {ms:.3f} ms, nn.BatchNorm2d {plain_ms:.3f} ms;"
            f" max error over max: " + ", ".join(
                f"{k} {v:.2e}" for k, v in err.items()) + f" (tol {tol}); "
            f"card {card}")
        out[name] = dict(ms=ms, plain_ms=plain_ms, rel_err=err)
    return out


def run_lane(torch, llama, train_step, cfg, card):
    import torch.distributed as dist

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    os.environ["HOROVOD_DEBUG_PORT"] = "0"
    hvd.init()
    try:
        rt = basics.lane()
        groups = rt.set_groups(0).groups
        backends = {"control": dist.get_backend(dist.group.WORLD),
                    **{k: dist.get_backend(g) for k, g in groups.items()}}
        nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
        check(hvd.size() == 1 and hvd.rank() == 0 and
              backends["cuda"] == "nccl" and backends["cpu"] == "gloo",
              f"lane: size {hvd.size()}, groups {backends}")
        log(f"  hvd.init(): world size {hvd.size()}, NCCL {nccl}, groups "
            f"{backends}, card {basics.device()}")
        ops = lane_ops(torch, hvd, rt)
        os.makedirs("build", exist_ok=True)
        hvd.start_timeline("build/lane_order_timeline.json")
        try:
            order = lane_stream_order(torch, hvd, rt)
        finally:
            hvd.stop_timeline()
        debug = lane_debug_port(hvd)
        grads, want, grad_info = lane_gradients(torch, hvd, rt, llama,
                                                train_step, cfg, card)
        cache_on = lane_sets(torch, hvd, rt, grads, want, card, "on")
        timeline = lane_timeline(torch, hvd, grads, card)
        sync_bn = lane_sync_bn(torch, hvd, card)
        events = {e["type"] for e in hvd.events()}
        check({"negotiate_begin", "negotiate_end", "response_launch",
               "phase", "wait"} <= events, f"lane events: {events}")
    finally:
        hvd.shutdown()
        del os.environ["HOROVOD_DEBUG_PORT"]
    os.environ["HOROVOD_CACHE_CAPACITY"] = "0"
    hvd.init()
    try:
        cache_off = lane_sets(torch, hvd, basics.lane(), grads, want, card,
                              "off")
    finally:
        hvd.shutdown()
        del os.environ["HOROVOD_CACHE_CAPACITY"]
    for label in cache_on:
        check(cache_on[label]["responses_steady"] ==
              cache_off[label]["responses_steady"],
              f"lane {label}: {cache_on[label]['responses_steady']} "
              f"responses a steady set with the cache, "
              f"{cache_off[label]['responses_steady']} without")
    log("  per gradient set, cache on / off (the lane before it had a "
        "response cache, same shapes and card: grouped 5.529-8.819 ms, "
        "0.653-2.958 ms negotiating per cycle; per leaf 6.103-16.442 ms, "
        "1.174-4.402 ms per cycle): " + "; ".join(
            f"{label} {cache_on[label]['ms']:.3f} / "
            f"{cache_off[label]['ms']:.3f} ms, "
            f"{cache_on[label]['negotiate_ms_per_cycle']:.3f} / "
            f"{cache_off[label]['negotiate_ms_per_cycle']:.3f} ms "
            f"negotiating per active cycle, "
            f"{cache_on[label]['execute_ms_per_response']:.3f} / "
            f"{cache_off[label]['execute_ms_per_response']:.3f} ms queuing "
            f"per response" for label in cache_on))
    del grads, want
    hvd.init(device="cpu")
    try:
        refused = raises(ValueError, lambda: hvd.allreduce(
            torch.ones(2, device="cuda")))
    finally:
        hvd.shutdown()
    check(refused, "a CUDA tensor on a lane opened with device='cpu' did "
          "not raise")
    log("  a CUDA tensor on a lane opened with device='cpu' raises")
    return dict(nccl=nccl, groups=backends, ops=ops, stream_order=order,
                gradients=grad_info, cache_on=cache_on, cache_off=cache_off,
                timeline=timeline, debug_server=debug, sync_bn=sync_bn)


# ---- phases 12-15: BERT-Large MLM (the kernels' bias variant) ----------

MASK_ID = 103   # [MASK] in BERT's uncased WordPiece vocabulary


def padding_lengths(torch, b, t, seed, empty=None):
    """Seeded sequence lengths in [128, t] (t = 512: BERT-Large's
    pretraining length), one sequence (``empty``) all padding."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.randint(min(128, t), t + 1, (b,), generator=g,
                            device="cuda")
    if empty is not None:
        lengths[empty] = 0
    return lengths


def padding_bias(torch, lengths, t):
    """BERT's kv bias: 0 on real keys, -1e30 on padding, f32 [B, T]."""
    keys = torch.arange(t, device="cuda")
    return torch.where(keys[None, :] < lengths[:, None], 0.0,
                       -1e30).float()


def bias_case(torch, fa, b, t, dtype, iters, attrs, kind, h=16, d=64):
    """K1, K2 and K3 with a per-key bias against their plain versions,
    non-causal: ``padding`` (seeded lengths in [128, t], the second
    sequence all padding) or ``random`` (N(0, 3^2) on every key). Times:
    each kernel, the FMA kernel on the same bf16 inputs (earlier), the
    plain versions, and SDPA with the bias as its additive mask (forward;
    backward alone on a saved forward), the yardstick only. The bound
    counts the pairs this run's data needs: every query against the real
    keys of its sequence."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(b * 1000 + t + 21)
    q, k, v, do = (torch.randn((b, h, t, d), generator=g,
                               device="cuda").to(dtype) for _ in range(4))
    if kind == "padding":
        lengths = padding_lengths(torch, b, t, 31, empty=1 % b)
        bias = padding_bias(torch, lengths, t)
        pairs = h * t * int(lengths.sum())
    else:
        bias = 3.0 * torch.randn((b, t), generator=g, device="cuda")
        pairs = b * h * t * t
    o, lse = fa._flash_fwd_cuda(q, k, v, False, bias)
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, False, bias)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, False, bias)
    want = fa._flash_bwd_reference(q, k, v, o, lse, do, False, bias)
    torch.cuda.synchronize()
    err = float((o.float() - o_ref.float()).abs().max())
    valid = lse_ref > -1e29
    check(torch.equal(lse > -1e29, valid),
          "K1 bias: rows without a valid key differ from the plain version")
    lse_err = float((lse - lse_ref)[valid].abs().max())
    rel_err = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        rel_err[name] = float((a.float() - w.float()).abs().max()) / max(
            float(w.float().abs().max()), 1e-30)
    empty_zero = kind != "padding" or all(
        not x[1 % b].float().any() for x in (o,) + tuple(got))
    delta = fa._delta(o, do)
    route = fa.flash_fwd_route(dtype, d)
    k1_ms = cuda_ms(torch, lambda: fa._flash_fwd_cuda(q, k, v, False, bias),
                    iters)
    k2_ms = cuda_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
        q, k, v, do, lse, delta, False, bias), iters)
    k3_ms = cuda_ms(torch, lambda: fa._flash_bwd_dq_cuda(
        q, k, v, do, lse, delta, False, bias), iters)
    k3_same = same_bits(torch, lambda: fa._flash_bwd_dq_cuda(
        q, k, v, do, lse, delta, False, bias))
    # The same kernels without the bias on the same inputs: what the add
    # costs.
    nobias = dict(
        K1=cuda_ms(torch, lambda: fa._flash_fwd_cuda(q, k, v, False), iters),
        K2=cuda_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, False), iters),
        K3=cuda_ms(torch, lambda: fa._flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, False), iters))
    earlier = {}
    if route == "wgmma":
        few = max(1, iters // 4)
        earlier = dict(
            K1=cuda_ms(torch, lambda: fa._flash_fwd_cuda(
                q, k, v, False, bias, route="fma"), few),
            K2=cuda_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
                q, k, v, do, lse, delta, False, bias, route="fma"), few),
            K3=cuda_ms(torch, lambda: fa._flash_bwd_dq_cuda(
                q, k, v, do, lse, delta, False, bias, route="fma"), few))
    plain_fwd_ms = cuda_ms(torch, lambda: fa._flash_fwd_reference(
        q, k, v, False, bias), max(1, iters // 4), warmup=1)
    plain_bwd_ms = cuda_ms(torch, lambda: fa._flash_bwd_reference(
        q, k, v, o, lse, do, False, bias), max(1, iters // 4), warmup=1)
    mask = bias[:, None, None, :].to(dtype)
    lib_fwd_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), iters)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    lib_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), iters)
    dname = str(dtype).replace("torch.", "")
    reads = nbytes(q, k, v, bias)
    bounds = dict(
        K1=bound(reads + nbytes(o, lse), 4 * d * pairs, dname),
        K2=bound(reads + nbytes(do, lse, delta, got[1], got[2]),
                 8 * d * pairs, dname),
        K3=bound(reads + nbytes(do, lse, delta, got[0]), 6 * d * pairs,
                 dname))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    name = f"B{b} H{h} T{t} D{d} {dname} {kind} bias"
    kms = {"K1": k1_ms, "K2": k2_ms, "K3": k3_ms}
    log(f"  bias {name}: route {route}; K1 max_abs_err {err:.3e} (tol "
        f"{tol:g}), lse_err {lse_err:.3e} (tol 1e-3); rel err dq "
        f"{rel_err['dq']:.3e} dk {rel_err['dk']:.3e} dv {rel_err['dv']:.3e} "
        f"(tol {tol:g}); the empty sequence all zeros: {empty_zero}; K3 same "
        f"bits on two launches: {k3_same}")
    for kname in ("K1", "K2", "K3"):
        ear = f", earlier (fma) {earlier[kname]:.4f} ms" if earlier else ""
        log(f"    {kname} {kms[kname]:.4f} ms (without the bias "
            f"{nobias[kname]:.4f} ms){ear}; bound "
            f"{bounds[kname][0]:.4f} ms ({bounds[kname][1]})")
    log(f"    plain forward {plain_fwd_ms:.4f} ms, backward "
        f"{plain_bwd_ms:.4f} ms; library (SDPA, additive mask) forward "
        f"{lib_fwd_ms:.4f} ms, backward {lib_bwd_ms:.4f} ms, forward + "
        f"backward {lib_fwd_ms + lib_bwd_ms:.4f} ms")
    check(err <= tol, f"K1 {name}: output error {err} above {tol}")
    check(lse_err <= 1e-3, f"K1 {name}: lse error {lse_err} above 1e-3")
    for grad, e in rel_err.items():
        check(e <= tol, f"K2/K3 {name}: {grad} error {e} above {tol}")
    check(empty_zero, f"{name}: the all-padding sequence is not all zeros")
    check(k3_same, f"K3 {name}: two launches gave different bits")

    def one(kname, max_abs, extra, plain_ms, library_ms, key):
        return dict(case=f"{kname} {name}", kernel_route=route,
                    max_abs_err=max_abs, ms=kms[kname],
                    no_bias_ms=nobias[kname],
                    earlier_ms=earlier.get(kname), plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bounds[kname][0],
                    bound_by=bounds[kname][1],
                    kernel_attrs=attrs.get(f"{kname} bias D{key}")
                    if route == "wgmma" else None, **extra)

    key = 128 if d == 128 else 64
    common = dict(library_fwd_bwd_ms=lib_fwd_ms + lib_bwd_ms)
    return {
        "K1": one("K1", err, dict(lse_max_abs_err=lse_err, **common),
                  plain_fwd_ms, lib_fwd_ms, key),
        "K2": one("K2", max(float((a.float() - w.float()).abs().max())
                            for a, w in zip(got[1:], want[1:])),
                  dict(rel_err={k: rel_err[k] for k in ("dk", "dv")},
                       **common), plain_bwd_ms, lib_bwd_ms, key),
        "K3": one("K3", float((got[0].float() - want[0].float()).abs()
                              .max()),
                  dict(rel_err={"dq": rel_err["dq"]}, same_bits=k3_same,
                       **common), plain_bwd_ms, lib_bwd_ms, key)}


def bert_batch(torch, cfg, batch, seq, seed):
    """Random MLM data from a seed: tokens, padding lengths in [128, seq],
    15% of the real tokens replaced by [MASK] and predicted."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    targets = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                            device="cuda", dtype=torch.int32)
    lengths = padding_lengths(torch, batch, seq, seed + 1)
    real = torch.arange(seq, device="cuda")[None, :] < lengths[:, None]
    picked = (torch.rand((batch, seq), generator=g, device="cuda") < 0.15) \
        & real
    tokens = torch.where(picked, MASK_ID, targets)
    return {"tokens": tokens, "targets": targets,
            "mlm_mask": picked.float(), "attention_mask": real.int()}


def bert_logits_case(torch, cfg, tokens, step_ms):
    """The MLM head's f32 logits product at the step's shape, [tokens, d]
    x [d, vocab] against the tied f32 embedding (TF32 off, as the smoke
    sets it): forward and backward (dh and the embedding's gradient) and
    their share of the train step."""
    g = torch.Generator(device="cuda").manual_seed(12)
    h = torch.randn((tokens, cfg.d_model), generator=g,
                    device="cuda").requires_grad_(True)
    w = (0.02 * torch.randn((cfg.vocab_size, cfg.d_model), generator=g,
                            device="cuda")).requires_grad_(True)
    out = h @ w.t()
    gout = torch.randn_like(out)
    fwd_ms = cuda_ms(torch, lambda: h.detach() @ w.detach().t(), 3)
    bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (h, w), gout, retain_graph=True), 3)
    flops = 2 * tokens * cfg.d_model * cfg.vocab_size
    share = (fwd_ms + bwd_ms) / step_ms
    log(f"  MLM logits f32 [{tokens}, {cfg.d_model}] x [{cfg.d_model}, "
        f"{cfg.vocab_size}]: forward {fwd_ms:.3f} ms "
        f"({flops / fwd_ms / 1e9:.1f} TFLOP/s), backward {bwd_ms:.3f} ms; "
        f"{share:.3f} of the train step's {step_ms:.1f} ms")
    return dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, step_share=share,
                fwd_tflops=flops / fwd_ms / 1e9)


def run_bert_train(torch, ctr, bert, precision, train_step, cfg, batch, seq,
                   warmup, steps, card):
    """BERT-Large MLM: split step, fused Adam 1e-4, full remat (per step
    K1 2L with the bias, K2 = K3 L), ``warmup`` steps then ``steps`` timed
    one by one on one fixed batch."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    params = bert.bert_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = sum(w.numel() for w in tree_leaves(params))
    log(f"  BERT-Large: {n_params / 1e6:.1f} M params (f32), bf16 compute, "
        f"remat={cfg.remat}")
    data = bert_batch(torch, cfg, batch, seq, 40)
    ts = train_step.make_split_train_step(
        lambda p, d: bert.bert_mlm_loss(p, d, cfg),
        precision.fused_adam(1e-4))
    carry = ts.init(params)
    del params
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    t0 = time.perf_counter()
    for _ in range(warmup):
        loss, carry = ts.step(carry, data)
        losses.append(loss)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reset_counts(ctr)
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, carry = ts.step(carry, data)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launched, biased = counts(ctr), bias_counts(ctr)
    check_wgmma_routes(ctr, "BERT train step")
    check_adam(ctr, "BERT train step", len(tree_leaves(carry[0])), steps)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    L = cfg.n_layers
    want = {"K1": 2 * L, "K2": L, "K3": L}
    for k, n in want.items():
        check(launched[k] == biased[k] == n * steps,
              f"{k} launched {launched[k]} times ({biased[k]} with the "
              f"bias) in {steps} steps, expected {n} per step, all biased")
    check(all(launched[k] == 0 for k in ("K4", "K5", "K6 dlhs", "K6 tgmm")),
          f"the BERT step launched a kernel off its path: {launched}")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    dt = float(np.median(step_s))
    tok = batch * seq
    flops_per_token = 6 * n_params + 12 * L * seq * cfg.d_model
    mfu = flops_per_token * tok / dt / PEAK_FLOPS["bfloat16"]
    log(f"  BERT-Large MLM train step B{batch} T{seq} remat={cfg.remat} "
        f"fused_adam(1e-4): {dt * 1e3:.1f} ms/step (median of {steps}; "
        f"{[round(s * 1e3, 1) for s in step_s]}), {tok / dt:.0f} tok/s, MFU "
        f"{mfu:.4f} ((6N + 12 L T d) per token at 989 TFLOP/s, remat not "
        f"credited), peak memory {peak / 2**30:.2f} GiB, first {warmup} "
        f"steps {first_s:.2f} s; losses {[round(x, 4) for x in losses]}; "
        f"launches {launched}, with the bias {biased} (per step: {want}); "
        f"card {card}")
    logits = bert_logits_case(torch, cfg, tok, dt * 1e3)
    prof = device_profile(torch, f"BERT-Large train step B{batch} T{seq}",
                          lambda: ts.step(carry, data), top=10)
    return launched, dict(ms_per_step=dt * 1e3, step_ms=[
        s * 1e3 for s in step_s], tok_s=tok / dt, mfu=mfu,
        peak_mem_gib=peak / 2**30, first_steps_s=first_s, losses=losses,
        n_params=n_params, bias_launches=biased, logits=logits,
        profile=prof), carry[0], data


def run_bert_forward(torch, ctr, bert, cfg, params, data, reps=5):
    """``bert_forward`` alone (no grad) on the train batch: ms (median),
    K1 once per layer with the bias."""
    def fwd():
        return bert.bert_forward(params, data["tokens"], cfg,
                                 attention_mask=data["attention_mask"])

    with torch.no_grad():
        fwd()
        torch.cuda.synchronize()
        reset_counts(ctr)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            logits = fwd()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launched, biased = counts(ctr), bias_counts(ctr)
    check_wgmma_routes(ctr, "bert_forward")
    L = cfg.n_layers
    check(launched["K1"] == biased["K1"] == L * reps and
          launched["K2"] == launched["K3"] == 0,
          f"bert_forward launches {launched} (bias {biased}) in {reps} "
          f"calls, expected K1 {L} per call, all biased")
    b, t = data["tokens"].shape
    check(tuple(logits.shape) == (b, t, cfg.vocab_size) and
          logits.dtype == torch.float32 and
          bool(torch.isfinite(logits).all()), "bert_forward logits")
    ms = float(np.median(times)) * 1e3
    log(f"  bert_forward B{b} T{t} (no grad): {ms:.2f} ms (median of "
        f"{reps}), {b * t / ms * 1e3:.0f} tok/s; launches per call "
        f"K1 {launched['K1'] // reps} (with the bias {biased['K1'] // reps})")
    return launched, dict(ms=ms, tok_s=b * t / ms * 1e3,
                          k1_per_call=launched["K1"] // reps)


def run_bert_parity(torch, ctr, fa, bert, train_step, cfg):
    """At BERT-Large widths, 2 layers, B4 x T128 with lengths {128, 77, 1,
    0}: f32 on the card (K1-K3's bias kernels on the FMA route) against
    the plain CPU path, loss to 1e-5 relative and each gradient leaf to
    2e-4 of its max abs; then bf16 on the card (wgmma) against bf16 on the
    CPU, each leaf held in norm to 2x its floor measured here
    (:func:`bf16_grad_agreement`)."""
    from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map

    c32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_params = bert.bert_init(c32, torch.Generator().manual_seed(3),
                                device="cpu")
    rng = np.random.default_rng(6)
    b, t = 4, 128
    targets = rng.integers(0, c32.vocab_size, (b, t)).astype(np.int32)
    mask = (np.arange(t)[None, :] < np.array([128, 77, 1, 0])[:, None])
    picked = (rng.random((b, t)) < 0.15) & mask
    picked[:3, 0] = True
    batch = {"tokens": np.where(picked, MASK_ID, targets).astype(np.int32),
             "targets": targets, "mlm_mask": picked.astype(np.float32),
             "attention_mask": mask.astype(np.int32)}

    def value_and_grad(params, c, device):
        loss, grads = train_step._value_and_grad(
            lambda p, d: bert.bert_mlm_loss(p, d, c, device=device), params,
            batch, 1)
        return float(loss), [g.float().cpu() for g in tree_leaves(grads)]

    t0 = time.perf_counter()
    cpu_loss, cpu_grads = value_and_grad(cpu_params, c32, "cpu")
    cpu_s = time.perf_counter() - t0
    card_params = tree_map(lambda w: w.cuda(), cpu_params)
    reset_counts(ctr)
    loss, grads = value_and_grad(card_params, c32, "cuda")
    launched, biased = counts(ctr), bias_counts(ctr)
    by_route = {k: dict(ctr[k].launches_by_route) for k in ("K1", "K2",
                                                            "K3")}
    loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
    grad_err = max(float((g - w).abs().max()) / max(float(w.abs().max()),
                                                    1e-30)
                   for g, w in zip(grads, cpu_grads))
    log(f"  f32 BERT parity (2 layers, B{b} T{t}, lengths 128/77/1/0): "
        f"card vs CPU loss {loss:.6f} vs {cpu_loss:.6f}, rel err "
        f"{loss_err:.3e} (tol 1e-5); grads {grad_err:.3e} (tol 2e-4 of each "
        f"leaf's max abs); launches {launched}, with the bias {biased}, by "
        f"route {by_route}; CPU grad call {cpu_s:.1f} s")
    want = {"K1": 4, "K2": 2, "K3": 2}
    check(all(launched[k] == biased[k] == n and
              by_route[k]["fma"] == n for k, n in want.items()),
          f"f32 BERT grad call launches {launched} (bias {biased}, routes "
          f"{by_route}), expected {want} on fma, all biased")
    check(loss_err <= 1e-5, f"card loss differs from CPU by {loss_err}")
    check(grad_err <= 2e-4, f"card grads differ from CPU by {grad_err}")
    c16 = dataclasses.replace(c32, dtype="bfloat16")
    bf16 = bf16_grad_agreement(
        torch, ctr, fa, lambda p, d: value_and_grad(p, c16, d), cpu_params,
        {"K1": 4, "K2": 2, "K3": 2}, "bf16 BERT grad call (2 layers, "
        f"B{b} T{t})")
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_err,
                launches=launched, bias_launches=biased,
                launches_by_route=by_route, cpu_grad_call_s=cpu_s,
                bf16=bf16)


# ---- phases 16-17: sequence parallelism (the kernels' offsets variant) ---


def visible_pairs(b, h, tq, tk, q_offset, kv_offset, causal=True):
    """The (query, key) pairs a chunk's causal mask leaves: key j is
    visible to query i iff kv_offset + j <= q_offset + i."""
    if not causal:
        return b * h * tq * tk
    rows = np.clip(q_offset - kv_offset + np.arange(tq) + 1, 0, tk)
    return b * h * int(rows.sum())


def offsets_case(torch, fa, label, b, tq, tk, q_offset, kv_offset, dtype,
                 iters, with_dlse=False, h=16, hkv=4, d=128):
    """K1, K2 and K3 with chunk offsets (one ring step) against their
    plain versions on the same inputs, causal; with ``with_dlse`` a
    random lse cotangent folded into delta. A wholly future chunk must
    give o, dq, dk, dv exactly 0 and a finite lse at or below -1e29.
    Times: each kernel, the FMA kernel on the same bf16 inputs (earlier),
    the plain versions, and SDPA with the chunk's boolean mask (forward;
    backward alone on a saved forward; SDPA returns no lse), the
    yardstick only. The bound counts the pairs the mask leaves."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(tq + 7 * tk + q_offset)
    q, do = (torch.randn((b, h, tq, d), generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, hkv, tk, d), generator=g,
                        device="cuda").to(dtype) for _ in range(2))
    dlse = torch.randn((b, h, tq, 1), generator=g, device="cuda") \
        if with_dlse else None
    offs = (q_offset, kv_offset)
    o, lse = fa._flash_fwd_cuda(q, k, v, True, None, offs)
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, True, None, offs)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, True, None, offs, dlse)
    want = fa._flash_bwd_reference(q, k, v, o, lse, do, True, None, offs,
                                   dlse)
    torch.cuda.synchronize()

    def rel(a, w):
        return float((a.float() - w.float()).abs().max()) / max(
            float(w.float().abs().max()), 1e-30)

    errs = {"o": rel(o, o_ref)}
    errs.update({n: rel(a, w) for n, a, w in zip(("dq", "dk", "dv"), got,
                                                 want)})
    valid = lse_ref > -1e29
    check(bool(torch.isfinite(lse).all()), f"{label}: non-finite lse")
    check(torch.equal(lse > -1e29, valid),
          f"{label}: rows without a visible key differ from the plain "
          "version")
    lse_err = float((lse - lse_ref)[valid].abs().max()) if valid.any() \
        else 0.0
    future = kv_offset > q_offset + tq - 1
    if future:
        check(not o.float().any() and not any(x.float().any() for x in got)
              and bool((lse <= -1e29).all()),
              f"{label}: a wholly future chunk must give exact zeros and "
              "lse <= -1e29")
        errs = {n: float((x.float() - w.float()).abs().max())
                for n, x, w in zip(("o", "dq", "dk", "dv"), (o,) + got,
                                   (o_ref,) + want)}
    delta = fa._delta(o, do, dlse)
    route = fa.flash_fwd_route(dtype, d)
    kms = dict(
        K1=cuda_ms(torch, lambda: fa._flash_fwd_cuda(q, k, v, True, None,
                                                     offs), iters),
        K2=cuda_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, True, None, offs), iters),
        K3=cuda_ms(torch, lambda: fa._flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, True, None, offs), iters))
    earlier = {}
    if route == "wgmma":
        few = max(1, iters // 4)
        earlier = dict(
            K1=cuda_ms(torch, lambda: fa._flash_fwd_cuda(
                q, k, v, True, None, offs, route="fma"), few),
            K2=cuda_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
                q, k, v, do, lse, delta, True, None, offs, route="fma"),
                few),
            K3=cuda_ms(torch, lambda: fa._flash_bwd_dq_cuda(
                q, k, v, do, lse, delta, True, None, offs, route="fma"),
                few))
    plain_fwd_ms = cuda_ms(torch, lambda: fa._flash_fwd_reference(
        q, k, v, True, None, offs), 2, warmup=1)
    plain_bwd_ms = cuda_ms(torch, lambda: fa._flash_bwd_reference(
        q, k, v, o, lse, do, True, None, offs, dlse), 2, warmup=1)
    mask = (kv_offset + torch.arange(tk, device="cuda"))[None, :] <= (
        q_offset + torch.arange(tq, device="cuda"))[:, None]
    lib_fwd_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True), iters)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                         enable_gqa=True)
    lib_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), iters)
    pairs = visible_pairs(b, h, tq, tk, q_offset, kv_offset)
    dname = str(dtype).replace("torch.", "")
    reads = nbytes(q, k, v)
    bwd_reads = reads + nbytes(do, lse, delta)
    bounds = dict(K1=bound(reads + nbytes(o, lse), 4 * d * pairs, dname),
                  K2=bound(bwd_reads + nbytes(got[1], got[2]),
                           8 * d * pairs, dname),
                  K3=bound(bwd_reads + nbytes(got[0]), 6 * d * pairs, dname))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    lse_tol = 1e-4 if dtype == torch.float32 else 1e-3
    name = (f"{label}: B{b} H{h} Hkv{hkv} Tq{tq} Tk{tk} D{d} {dname} "
            f"offsets ({q_offset}, {kv_offset})"
            f"{' dlse' if with_dlse else ''}")
    log(f"  {name}: route {route}; error of the reference's max: "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {tol:g}{', exact 0 here' if future else ''}); lse_err "
        f"{lse_err:.3e} (tol {lse_tol:g}); {pairs} visible pairs")
    for kname in ("K1", "K2", "K3"):
        ear = f", earlier (fma) {earlier[kname]:.4f} ms" if earlier else ""
        log(f"    {kname} {kms[kname]:.4f} ms{ear}; bound "
            f"{bounds[kname][0]:.4f} ms ({bounds[kname][1]})")
    log(f"    plain forward {plain_fwd_ms:.4f} ms, backward "
        f"{plain_bwd_ms:.4f} ms; library (SDPA, boolean mask; it gives no "
        f"lse) forward {lib_fwd_ms:.4f} ms, backward {lib_bwd_ms:.4f} ms")
    for n, e in errs.items():
        check(e <= (0.0 if future else tol),
              f"{name}: {n} error {e} above {tol}")
    check(lse_err <= lse_tol, f"{name}: lse error {lse_err}")

    def one(kname, err, plain_ms, library_ms):
        return dict(case=f"{kname} {name}", kernel_route=route,
                    max_abs_err=err, ms=kms[kname],
                    earlier_ms=earlier.get(kname), plain_ms=plain_ms,
                    library_ms=library_ms, library_note="SDPA: no lse",
                    bound_ms=bounds[kname][0], bound_by=bounds[kname][1],
                    visible_pairs=pairs)

    def max_abs(a, w):
        return float((a.float() - w.float()).abs().max())

    return {"K1": one("K1", max_abs(o, o_ref), plain_fwd_ms, lib_fwd_ms),
            "K2": one("K2", max(max_abs(got[1], want[1]),
                                max_abs(got[2], want[2])), plain_bwd_ms,
                      lib_bwd_ms),
            "K3": one("K3", max_abs(got[0], want[0]), plain_bwd_ms,
                      lib_bwd_ms)}


def run_ring_replay(torch, ctr, fa, ring_flash_steps, n=4, b=1, t=16384,
                    h=16, hkv=4, d=128, iters=3):
    """A seq=n ring replayed on one card: for each rank, its n steps
    through ``ring_flash_steps`` (the port's ring step loop; the rotation
    hands it the pre-split K/V chunks a ring would pass it) forward and
    backward, its launches counted (n offsets K1, n K2 and n K3, all on
    wgmma) and timed. The ranks' o, dq, dk and dv, joined, are held
    against the one-card K1-K3 over the whole sequence in norm: 2x the
    floor between the one-card wgmma and FMA kernels (two correct
    kernels rounding in other places), plus 1e-2, as phase 15 does."""
    g = torch.Generator(device="cuda").manual_seed(161)
    bf16 = torch.bfloat16
    q, do = (torch.randn((b, h, t, d), generator=g, device="cuda").to(bf16)
             for _ in range(2))
    k, v = (torch.randn((b, hkv, t, d), generator=g, device="cuda").to(bf16)
            for _ in range(2))
    tc = t // n
    chunks = [[x.contiguous() for x in y.split(tc, 2)] for y in (q, k, v,
                                                                 do)]

    def rank_run(idx):
        qi = chunks[0][idx].detach().requires_grad_(True)
        kv = [x.detach().requires_grad_(True) for x in chunks[1] + chunks[2]]
        at = [idx]

        def rotate(kt, vt):
            at[0] = (at[0] - 1) % n
            return kv[at[0]], kv[n + at[0]]

        o, _ = ring_flash_steps(qi, kv[idx], kv[n + idx], idx, n, rotate)
        o = o.to(bf16)
        grads = torch.autograd.grad(o, [qi] + kv, chunks[3][idx])
        return o.detach(), grads

    parts, per_rank = [], []
    for idx in range(n):
        reset_counts(ctr)
        o, grads = rank_run(idx)
        torch.cuda.synchronize()
        launched = offsets_counts(ctr)
        by_route = check_wgmma_routes(ctr, f"ring rank {idx}")
        check(launched == {"K1": n, "K2": n, "K3": n}
              and counts(ctr)["K1"] == n,
              f"ring rank {idx}: offsets launches {launched}, expected "
              f"{n} each")
        parts.append((o, grads))
        per_rank.append(dict(rank=idx, launches=launched,
                             launches_by_route=by_route))
    for idx in range(n):
        per_rank[idx]["ms"] = cuda_ms(torch, lambda: rank_run(idx), iters,
                                      warmup=1)
    # Where a rank's time goes: its kernels, the merge's elementwise
    # passes, the host between them (the busiest rank and the lightest).
    profiles = {idx: device_profile(torch, f"ring rank {idx} forward + "
                                    "backward", lambda: rank_run(idx))
                for idx in (n - 1, 0)}
    o_ring = torch.cat([p[0] for p in parts], 2)
    dq_ring = torch.cat([p[1][0] for p in parts], 2)
    dk_ring = torch.cat([sum(p[1][1 + j].float() for p in parts)
                         for j in range(n)], 2)
    dv_ring = torch.cat([sum(p[1][1 + n + j].float() for p in parts)
                         for j in range(n)], 2)

    def one_card(route):
        o, lse = fa._flash_fwd_cuda(q, k, v, True, route=route)
        delta = fa._delta(o, do)
        dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True,
                                        route=route)
        dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, True,
                                   route=route)
        return (o, dq) + fa._sum_kv_heads(dk, dv, hkv)

    want = one_card("wgmma")
    floor = [norm_rel(a, w) for a, w in zip(one_card("fma"), want)]
    err = [norm_rel(a, w) for a, w in zip(
        (o_ring, dq_ring, dk_ring, dv_ring), want)]
    whole_ms = cuda_ms(torch, lambda: one_card("wgmma"), iters, warmup=1)
    names = ("o", "dq", "dk", "dv")
    log(f"  seq={n} ring replayed at B{b} T{t} H{h} Hkv{hkv} D{d} bf16 "
        f"(chunks of {tc}): norm-relative error against one-card K1-K3 "
        + ", ".join(f"{nm} {e:.3e}" for nm, e in zip(names, err))
        + "; floor (one-card FMA vs wgmma) "
        + ", ".join(f"{nm} {f:.3e}" for nm, f in zip(names, floor))
        + " (tol 2 x floor + 1e-2)")
    for r in per_rank:
        log(f"    rank {r['rank']}: {r['ms']:.3f} ms forward + backward "
            f"over its {n} steps; offsets launches {r['launches']}, by "
            f"route K1 {r['launches_by_route']['K1']}")
    log(f"    one card, whole sequence, K1 + K2 + K3 (and the delta, "
        f"the n_rep sum): {whole_ms:.3f} ms")
    for nm, e, f in zip(names, err, floor):
        check(e <= 2 * f + 1e-2, f"ring replay: {nm} error {e} above 2 x "
              f"floor {f} + 1e-2")
    log("  multi-rank ring and Ulysses on NCCL: not run (this machine has "
        "one card, and NCCL refuses two ranks on one device); their "
        "multi-rank numerics are held on the CPU over gloo "
        "(tests/test_torch_seq_parallel.py)")
    return dict(shape=f"B{b} T{t} H{h} Hkv{hkv} D{d} bf16 seq={n}",
                norm_rel_err=dict(zip(names, err)),
                floor=dict(zip(names, floor)), per_rank=per_rank,
                profiles=profiles, one_card_ms=whole_ms,
                launches={k: sum(r["launches"][k] for r in per_rank)
                          for k in ("K1", "K2", "K3")})


# ---- phase 18: elastic training on NCCL (world size 1) -----------------


def copy_rates(torch, nbytes=1 << 30, iters=8):
    """The host link's pinned copy rates, device to host and host to
    device, in bytes/s: the fastest of ``iters`` copies of 1 GiB each
    way (CUDA events around each), the rate a bound may assume."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def best_ms(dst, src):
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return min(times)

    d2h, h2d = best_ms(host, dev), best_ms(dev, host)
    del dev, host
    return nbytes / d2h * 1e3, nbytes / h2d * 1e3


def host_copy(torch, tensors):
    return [t.detach().to("cpu", copy=True) for t in tensors]


def leaf_agreement(torch, got, want):
    """(largest norm-relative difference, bit-identical) over the leaves."""
    worst, same = 0.0, True
    for g, w in zip(got, want):
        worst = max(worst, norm_rel(g, w))
        same = same and torch.equal(g, w)
    return worst, same


def timed_state(base, sync, torch_cuda):
    """``base`` (an elastic state class) with its commit() and restore()
    timed, and the reset between a restore and the state's on_reset
    (run_fn calls reset() there; the post-reset hooks included), in
    ``.times``."""

    class Timed(base):
        def _timed(self, key, fn):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            self.times.setdefault(key, []).append(
                (time.perf_counter() - t0) * 1e3)
            self.t_last = time.perf_counter()

        def commit(self):
            self._timed("commit", super().commit)
            # Fresh page-locked blocks so far (the pinned-memory cache's
            # misses) and the ms spent creating them, where torch says.
            stats = getattr(torch_cuda, "host_memory_stats", None)
            stats = stats() if stats else {}
            self.times.setdefault("host_allocs", []).append(
                (stats.get("num_host_alloc"),
                 stats.get("host_alloc_time.total", 0) / 1e3))

        def restore(self):
            self._timed("restore", super().restore)

        def on_reset(self):
            self.times.setdefault("reset", []).append(
                (time.perf_counter() - self.t_last) * 1e3)
            super().on_reset()

    Timed.times = None
    return Timed


def run_elastic(torch, ctr, bert, precision, train_step, cfg, batch, seq,
                card, step13_ms):
    """Elastic BERT-Large MLM on the lane at world size 1 (NCCL): (a) the
    reference's torch elastic API (an nn.Module over ``bert_init``'s
    params, ``hvd.DistributedOptimizer(Adam(1e-4))`` under
    ``@hvd.elastic.run`` with ``TorchState``; 6 steps, a commit every 2,
    each step's gradients one ``grouped_allreduce_async_`` Average on the
    card) and (b) the port's split step under ``TreeState`` (4 steps, one
    commit). A step past step 2's commit ((a) at step 4, after the
    backward with the group in flight; (b) after step 3's in-place
    update), the training function raises ``HorovodInternalError`` once:
    the state rolls back to step 2's commit, ``reset()`` re-inits the
    lane at epoch 1 (a new NCCL group) and steps 3.. replay. Each run is
    held against a fault-free run from the same seed."""
    import torch.distributed as dist

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.parallel._tree import tree_leaves, tree_unflatten

    dev, sync = "cuda", torch.cuda.synchronize
    TimedTorchState = timed_state(hvd.elastic.TorchState, sync, torch.cuda)
    TimedTreeState = timed_state(hvd.elastic.TreeState, sync, torch.cuda)
    data = bert_batch(torch, cfg, batch, seq, 40)

    def phase_us():
        """The lane's control-phase sums so far (hvd.metrics())."""
        return {k: v["sum_us"]
                for k, v in hvd.metrics()["control_phase"].items()}

    def init_params():
        return bert.bert_init(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)

    class MLM(torch.nn.Module):
        """Phase glue: bert_init's params as a module whose forward is
        bert_mlm_loss."""

        def __init__(self, params):
            super().__init__()
            self.like = params
            self.flat = torch.nn.ParameterList(
                torch.nn.Parameter(t) for t in tree_leaves(params))

        def forward(self, batch):
            return bert.bert_mlm_loss(
                tree_unflatten(self.like, list(self.flat)), batch, cfg,
                device=dev)

    hvd.init(device=dev)
    try:
        group0 = basics.lane().set_groups(0).groups
        reset_counts(ctr)

        def torch_run(fault, steps=6):
            model = MLM(init_params())
            opt = hvd.DistributedOptimizer(
                torch.optim.Adam(model.parameters(), lr=1e-4))
            state = TimedTorchState(model, opt, step=0)
            state.times = {}
            losses, step_ms, seen = {}, {}, {}
            epoch0 = basics.epoch()

            @hvd.elastic.run
            def train(state):
                if basics.epoch() > epoch0 and "restored" not in seen:
                    # Back from the fault: the tensors equal the commit's
                    # bit for bit, on the card (Adam's step counts stay
                    # on the host), in their dtypes.
                    saved = state._saved
                    live = [(p, saved["model"][k])
                            for k, p in model.state_dict().items()] + [
                        (v, saved["optimizer"]["state"][i][key])
                        for i, st in opt.state_dict()["state"].items()
                        for key, v in st.items()]
                    seen["restored"] = all(
                        (v.device.type == dev or v.dim() == 0) and
                        v.dtype == w.dtype and torch.equal(v.cpu(), w)
                        for v, w in live)
                while state.step < steps:
                    t0 = time.perf_counter()
                    opt.zero_grad()
                    loss = model(data)
                    loss.backward()
                    handles = hvd.grouped_allreduce_async_(
                        [p.grad for p in model.parameters()], op=hvd.Average)
                    if fault and state.step == 3 and "raised" not in seen:
                        seen["raised"] = sum(not h.poll() for h in handles)
                        seen["group"] = basics.lane().set_groups(0).groups
                        # Step 3 has moved the params past the commit.
                        seen["moved"] = any(
                            not torch.equal(p.detach().cpu(),
                                            state._saved["model"][k])
                            for k, p in model.state_dict().items())
                        raise hvd.HorovodInternalError(
                            "injected after the backward, the gradient "
                            "group in flight")
                    for h in handles:
                        h.synchronize()
                    opt.step()
                    losses[state.step + 1] = float(loss.detach())
                    step_ms.setdefault(state.step + 1, []).append(
                        (time.perf_counter() - t0) * 1e3)
                    state.step += 1
                    if state.step % 2 == 0:
                        state.commit()
                        if state.step == 2 and "committed" not in seen:
                            seen["committed"] = all(
                                torch.equal(p.detach().cpu(),
                                            state._saved["model"][k])
                                for k, p in model.state_dict().items())

            train(state)
            sync()
            leaves = host_copy(torch, list(model.parameters()) + [
                v for st in opt.state.values() for k, v in sorted(st.items())
                if k in ("exp_avg", "exp_avg_sq")])
            return dict(leaves=leaves, losses=losses, step_ms=step_ms,
                        seen=seen, times=state.times, epoch=basics.epoch())

        def tree_run(fault, steps=4):
            ts = train_step.make_split_train_step(
                lambda p, d: bert.bert_mlm_loss(p, d, cfg, device=dev),
                precision.fused_adam(1e-4))
            state = TimedTreeState(carry=ts.init(init_params()), step=0)
            state.times = {}
            losses, step_ms, seen = {}, {}, {}
            epoch0 = basics.epoch()

            @hvd.elastic.run
            def train(state):
                if basics.epoch() > epoch0 and "restored" not in seen:
                    seen["restored"] = all(
                        t.device.type == dev and t.dtype == s.dtype and
                        torch.equal(t.cpu(), s) for t, s in zip(
                            tree_leaves(state.carry[0]) +
                            tree_leaves(state.carry[1].mu) +
                            tree_leaves(state.carry[1].nu),
                            tree_leaves(state._saved["carry"][0]) +
                            tree_leaves(state._saved["carry"][1].mu) +
                            tree_leaves(state._saved["carry"][1].nu)))
                while state.step < steps:
                    t0 = time.perf_counter()
                    loss, carry = ts.step(state.carry, data)
                    if fault and state.step == 2 and "raised" not in seen:
                        # fused_adam has written the carry in place,
                        # past the commit.
                        seen["raised"] = True
                        seen["moved"] = any(
                            not torch.equal(t.cpu(), s) for t, s in zip(
                                tree_leaves(state.carry[0]),
                                tree_leaves(state._saved["carry"][0])))
                        raise hvd.HorovodInternalError(
                            "injected after the step")
                    losses[state.step + 1] = float(loss)
                    step_ms.setdefault(state.step + 1, []).append(
                        (time.perf_counter() - t0) * 1e3)
                    state.carry = carry
                    state.step += 1
                    if state.step == 2:
                        state.commit()
                        seen.setdefault("committed", all(
                            torch.equal(t.cpu(), s) for t, s in zip(
                                tree_leaves(state.carry[0]),
                                tree_leaves(state._saved["carry"][0]))))

            train(state)
            sync()
            params, opt = state.carry
            leaves = host_copy(torch, tree_leaves(params) +
                               tree_leaves(opt.mu) + tree_leaves(opt.nu))
            return dict(leaves=leaves, losses=losses, step_ms=step_ms,
                        seen=seen, times=state.times, epoch=basics.epoch())

        out = {}
        for name, fn, replayed in (("torch_state", torch_run, (3, 4, 5, 6)),
                                   ("tree_state", tree_run, (3, 4))):
            clean = fn(False)
            epoch0, before = basics.epoch(), phase_us()
            faulted = fn(True)
            after = phase_us()
            check(faulted["epoch"] == epoch0 + 1,
                  f"{name}: epoch {faulted['epoch']} after the fault, "
                  f"expected {epoch0 + 1}")
            check(faulted["seen"].get("restored"),
                  f"{name}: restore() did not give back the committed "
                  "tensors bit for bit on the card in their dtypes")
            check(faulted["seen"]["committed"],
                  f"{name}: step 2's commit does not hold the live params")
            check(faulted["seen"]["moved"],
                  f"{name}: the params had not moved past the commit at "
                  "the fault, so restore() was not tested")
            worst, same = leaf_agreement(torch, faulted["leaves"],
                                         clean["leaves"])
            check(worst <= 1e-3, f"{name}: params/moments {worst:.3e} from "
                  "the fault-free run (bound 1e-3, norm-relative)")
            loss_err = max(abs(faulted["losses"][s] - clean["losses"][s]) /
                           abs(clean["losses"][s]) for s in replayed)
            check(loss_err <= 1e-3, f"{name}: replayed losses "
                  f"{faulted['losses']} vs {clean['losses']}")
            replay_ms = [faulted["step_ms"][s][-1] for s in replayed]
            t = faulted["times"]
            out[name] = dict(
                epoch=faulted["epoch"], max_norm_rel=worst,
                bit_identical=same, loss_rel_err=loss_err,
                losses=faulted["losses"], clean_losses=clean["losses"],
                commit_ms=t["commit"], host_allocs=t["host_allocs"],
                restore_ms=t["restore"],
                reset_ms=t["reset"], replay_ms=replay_ms,
                seen={k: v for k, v in faulted["seen"].items()
                      if k != "group"},
                # The one reset's shutdown, init and NCCL communicator.
                reset_split={k: (after.get(k, 0) - before.get(k, 0)) / 1e3
                             for k in ("shutdown", "rendezvous",
                                       "nccl_init")})
            if name == "torch_state":
                group = faulted["seen"]["group"]["cuda"]
                now = basics.lane().set_groups(0).groups["cuda"]
                # (Group names restart with torch.distributed's world.)
                check(now is not group,
                      "the lane's group was not re-created by reset()")
            # The params and the Adam moments a commit copies.
            out[name]["state_bytes"] = sum(nbytes(x)
                                           for x in clean["leaves"])
            del clean, faulted
        check(group0 is not basics.lane().set_groups(0).groups,
              "the lane kept its first epoch's groups")
        launched, biased = counts(ctr), bias_counts(ctr)
        check_wgmma_routes(ctr, "elastic BERT")
        # Per grad call K1 2L (the forward and the remat recompute), K2 =
        # K3 L: (a) 6 + 8 calls (steps 3 and 4 ran before the fault, the
        # faulted one its backward), (b) 4 + 5.
        L = cfg.n_layers
        for k, n in {"K1": 2 * L, "K2": L, "K3": L}.items():
            check(launched[k] == biased[k] == n * 23,
                  f"elastic BERT: {k} launched {launched[k]} times "
                  f"({biased[k]} with the bias), expected {n * 23}")
        check(all(launched[k] == 0 for k in ("K4", "K5", "K6 dlhs",
                                              "K6 tgmm")),
              f"elastic BERT launched a kernel off its path: {launched}")
        out["epoch"] = basics.epoch()
        out["backend"] = dist.get_backend(
            basics.lane().set_groups(0).groups["cuda"])
        # The split step's ms with the lane's thread cycling beside it,
        # then (below) with the lane closed: the host-bound step shares
        # the interpreter with the lane's negotiation.
        lane_open = split_step_ms(torch, bert, precision, train_step, cfg,
                                  data, dev, sync)
    finally:
        hvd.shutdown()
    lane_closed = split_step_ms(torch, bert, precision, train_step, cfg,
                                data, dev, sync)
    out["split_step_ms"] = dict(lane_open=lane_open, lane_closed=lane_closed)
    log(f"  the split step alone, 3 steps after one: lane open "
        f"{[round(x, 1) for x in lane_open]} ms, lane closed "
        f"{[round(x, 1) for x in lane_closed]} ms")
    d2h, h2d = copy_rates(torch)
    for name in ("torch_state", "tree_state"):
        r = out[name]
        gb = r["state_bytes"] / 1e9
        r.update(d2h_bytes_per_s=d2h, h2d_bytes_per_s=h2d,
                 commit_bound_ms=r["state_bytes"] / d2h * 1e3,
                 restore_bound_ms=r["state_bytes"] / h2d * 1e3)
        split = r["reset_split"]
        log(f"  {name}: epoch {r['epoch']} after the fault; final params "
            f"and moments {r['max_norm_rel']:.3e} from the fault-free run "
            f"(norm-relative, bound 1e-3; bit-identical: "
            f"{r['bit_identical']}); replayed losses within "
            f"{r['loss_rel_err']:.2e}; commit of {gb:.3f} GB "
            f"{[round(x, 1) for x in r['commit_ms']]} ms (pinned blocks "
            f"created so far, and their ms: {r['host_allocs']}; bound "
            f"{r['commit_bound_ms']:.1f} ms at the pinned device-to-host "
            f"rate {d2h / 1e9:.2f} GB/s); restore "
            f"{[round(x, 1) for x in r['restore_ms']]} ms (bound "
            f"{r['restore_bound_ms']:.1f} ms at {h2d / 1e9:.2f} GB/s "
            f"host-to-device); reset {[round(x, 1) for x in r['reset_ms']]}"
            f" ms (shutdown {split['shutdown']:.1f}; init "
            f"{split['rendezvous']:.1f}, of it the NCCL communicator "
            f"{split['nccl_init']:.1f}); replayed "
            f"steps {[round(x, 1) for x in r['replay_ms']]} ms/step "
            f"(phase 13: {step13_ms:.1f}); card {card}")
    out["launches"], out["bias_launches"] = launched, biased
    return launched, out


def split_step_ms(torch, bert, precision, train_step, cfg, data, dev, sync,
                  steps=3):
    """ms of ``steps`` split steps after a first, on a fresh carry."""
    ts = train_step.make_split_train_step(
        lambda p, d: bert.bert_mlm_loss(p, d, cfg, device=dev),
        precision.fused_adam(1e-4))
    carry = ts.init(bert.bert_init(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    out = []
    for i in range(steps + 1):
        sync()
        t0 = time.perf_counter()
        loss, carry = ts.step(carry, data)
        float(loss)
        if i:
            out.append((time.perf_counter() - t0) * 1e3)
    return out


# ---- phase 19: the lane's autotuner and the parole door --------------


def timed_sets(torch, fn, sets=12, warmup=2):
    """``sets`` runs of a gradient set: the ms of each after ``warmup``,
    and the lane's host ms per active cycle (negotiation) over them."""
    from horovod_tpu_torch.common.metrics import REGISTRY

    for _ in range(warmup):
        fn()
    neg0 = (REGISTRY.negotiation_us.sum, REGISTRY.negotiation_us.count)
    times = []
    for _ in range(sets - warmup):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    cycles = REGISTRY.negotiation_us.count - neg0[1]
    host = (REGISTRY.negotiation_us.sum - neg0[0]) / 1e3 / max(cycles, 1)
    return times, host


def check_autotune_log(path, knobs, steps):
    """Every row of the tuner's CSV well formed, ``steps`` scored rows
    and the converged point last, equal to ``knobs``."""
    from horovod_tpu_torch.common import parameter_manager as pmod

    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    check(lines and lines[0] == pmod.HEADER,
          f"autotune log header {lines[:1]}")
    rows = [line.rstrip("\n").split(",") for line in lines[1:]]
    for r in rows:
        check(len(r) == 7 and int(r[0]) in pmod.FUSION_VALUES and
              float(r[1]) in pmod.CYCLE_VALUES and
              r[1] == f"{float(r[1]):.3f}" and
              r[2:6] == ["0", "0", "0", "1"] and
              r[6] == str(int(r[6])) and int(r[6]) >= 0,
              f"autotune log row {r}")
    check(len(rows) == steps + 1,
          f"autotune log: {len(rows)} rows for {steps} scored windows")
    last = (int(rows[-1][0]), float(rows[-1][1]))
    check(last == (knobs["fusion_threshold_bytes"], knobs["cycle_time_ms"]),
          f"autotune: the log's last row {rows[-1]} is not the live knobs "
          f"{knobs}")
    return rows


def lane_autotune(torch, hvd, llama, cfg, card, bound_ms, cap_s=60.0):
    """(a) ``HOROVOD_AUTOTUNE=1`` over the flagship's bf16 gradient sets
    (phase 11's grouped set: the gradient leaves' shapes, random values)
    until the tuner converged (3 warm-up windows + 20 scored), at most
    ``cap_s``; then ms per set at the converged knobs and at the default
    ones (64 MiB, 1 ms, no tuner)."""
    import tempfile

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.parallel._tree import tree_leaves

    params = llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(19)
    grads = [torch.randn(p.shape, generator=gen, device="cuda",
                         dtype=torch.float32).to(p.dtype)
             for p in tree_leaves(params)]
    del params
    gbytes = sum(g.nbytes for g in grads)
    fn = lane_set_fns(torch, hvd, grads)["grouped_allreduce_"]
    tmp = tempfile.mkdtemp(prefix="hvd_autotune_")
    log_path = os.path.join(tmp, "autotune.csv")
    os.environ.update(HOROVOD_AUTOTUNE="1", HOROVOD_AUTOTUNE_LOG=log_path)
    hvd.init()
    try:
        pm = basics.lane().param_manager
        check(pm is not None and not pm.done,
              "HOROVOD_AUTOTUNE=1 built no tuner on rank 0")
        t0, sets = time.perf_counter(), 0
        while not pm.done:
            waited = time.perf_counter() - t0
            check(waited < cap_s, f"autotune did not converge in {cap_s} s: "
                  f"{pm._opt.num_samples} of {pm.max_samples} windows scored "
                  f"after {sets} gradient sets")
            fn()
            sets += 1
        tune_s = time.perf_counter() - t0
        fn()            # a cycle past the converging one
        knobs = hvd.metrics()["knobs"]
        rows = check_autotune_log(log_path, knobs, pm.max_samples)
        moves = [e for e in hvd.events() if e["type"] == "knob_adopt"]
        tuned_ms, tuned_host = timed_sets(torch, fn)
    finally:
        hvd.shutdown()
        for k in ("HOROVOD_AUTOTUNE", "HOROVOD_AUTOTUNE_LOG"):
            del os.environ[k]
    hvd.init()
    try:
        default = hvd.metrics()["knobs"]
        check(basics.lane().param_manager is None and default == {
            "fusion_threshold_bytes": 64 << 20, "cycle_time_ms": 1.0,
            "wire_compression": False, "wire_codec": "off",
            "cross_plane": "auto", "hier_split": 0,
            "cross_compression": False},
            f"the lane without HOROVOD_AUTOTUNE: knobs {default}")
        default_ms, default_host = timed_sets(torch, fn)
    finally:
        hvd.shutdown()
    del grads
    torch.cuda.empty_cache()
    out = dict(
        converged=knobs, sets_to_converge=sets, tune_s=tune_s,
        log_rows=[[int(r[0]), float(r[1]), int(r[6])] for r in rows],
        knob_adopt_events=len(moves), grad_bytes=gbytes,
        converged_ms=float(np.median(tuned_ms)), converged_times_ms=tuned_ms,
        converged_host_ms_per_cycle=tuned_host,
        default_ms=float(np.median(default_ms)), default_times_ms=default_ms,
        default_host_ms_per_cycle=default_host, bound_ms=bound_ms)
    log(f"  autotune: converged after {sets} grouped gradient sets "
        f"({gbytes / 1e9:.3f} GB bf16 each) in {tune_s:.2f} s, "
        f"{len(rows) - 1} windows scored, {len(moves)} knob_adopt events; "
        f"converged point fusion {knobs['fusion_threshold_bytes']} bytes, "
        f"cycle {knobs['cycle_time_ms']} ms (the log's last row, "
        f"{rows[-1][6]} B/s mean score; hvd.metrics()['knobs'] equal); "
        f"ms per gradient set (median of {len(tuned_ms)}): converged "
        f"{out['converged_ms']:.3f} (spread {min(tuned_ms):.3f}-"
        f"{max(tuned_ms):.3f}; host {tuned_host:.3f} ms per active cycle), "
        f"default 64 MiB / 1 ms {out['default_ms']:.3f} (spread "
        f"{min(default_ms):.3f}-{max(default_ms):.3f}; host "
        f"{default_host:.3f} ms per active cycle); phase 11's bound of the "
        f"bytes moved {bound_ms:.3f} ms; card {card}")
    return out


def lane_door(torch, hvd, bert, precision, train_step, bcfg, card,
              reset18_ms):
    """(b) The parole door at world size 1 on NCCL: rank 0's door and its
    TCP store, ``/healthz``'s ``pending_rejoiners``, the commit-time poll
    (local at size 1), BERT-Large commits (phase 18's ``TreeState`` over
    the split step's carry) with the door and without, an injected
    ``HorovodInternalError`` whose reset reads the door (``parole_freeze``);
    (c) ``shrink(set())``: a voluntary re-formation at the next epoch."""
    import socket
    import urllib.request

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common import elastic as hvd_elastic
    from horovod_tpu_torch.parallel._tree import tree_leaves

    dev, sync = "cuda", torch.cuda.synchronize
    TimedTreeState = timed_state(hvd.elastic.TreeState, sync, torch.cuda)
    ts = train_step.make_split_train_step(
        lambda p, d: bert.bert_mlm_loss(p, d, bcfg, device=dev),
        precision.fused_adam(1e-4))
    carry = ts.init(bert.bert_init(
        bcfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    state_bytes = sum(t.nbytes for t in tree_leaves(carry[0]) +
                      tree_leaves(carry[1].mu) + tree_leaves(carry[1].nu))

    def phases():
        return {k: v["sum_us"] / 1e3
                for k, v in hvd.metrics()["control_phase"].items()}

    def poll_us(n=1000):
        t0 = time.perf_counter()
        for _ in range(n):
            hvd_elastic._poll_rejoiners()
        return (time.perf_counter() - t0) / n * 1e6

    def commits(n=3):
        state = TimedTreeState(carry=carry, step=0)
        state.times = {}
        for _ in range(n):
            state.commit()
        return state, state.times["commit"]

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    # The door, and the TCP store rank 0 hosts beside it, on free ports.
    door_port = free_port()
    os.environ.update(HOROVOD_REJOIN_PORT=str(door_port),
                      HOROVOD_CONTROLLER_PORT=str(free_port()),
                      HOROVOD_DEBUG_PORT="0")
    out = {}
    hvd.init()
    try:
        check(hvd_elastic._door is not None and basics._store is not None,
              "HOROVOD_REJOIN_PORT at world size 1: no door, or no TCP "
              "store for a joiner to reach")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{hvd.debug_port()}/healthz",
                timeout=30) as r:
            health = json.loads(r.read().decode())
        check(health["pending_rejoiners"] == 0,
              f"/healthz pending_rejoiners {health.get('pending_rejoiners')}")
        out["poll_us_door"] = poll_us()
        state, times = commits()
        out["commit_ms_door"] = list(times)
        before, epoch0, seen = phases(), basics.epoch(), {}

        @hvd.elastic.run
        def train(state):
            leaf = tree_leaves(state.carry[0])[0]
            if "raised" in seen:
                seen["restored"] = torch.equal(
                    leaf.cpu(), tree_leaves(state._saved["carry"][0])[0])
                return
            state.commit()
            leaf.add_(1)       # past the commit
            seen["raised"] = True
            raise hvd.HorovodInternalError("injected after the commit")

        train(state)
        after = phases()
        check(seen.get("restored") and basics.epoch() == epoch0 + 1,
              f"door lane: restore {seen}, epoch {basics.epoch()}")
        freeze = hvd.metrics()["control_phase"].get("parole_freeze")
        check(freeze is not None and freeze["count"] >= 1,
              "the reset read no parole_freeze")
        out.update(parole_freeze_ms=(after["parole_freeze"] -
                                     before.get("parole_freeze", 0)),
                   fault_reset_ms=state.times["reset"],
                   fault_reset_split={k: after.get(k, 0) - before.get(k, 0)
                                      for k in ("shutdown", "rendezvous",
                                                "nccl_init")})
        # (c) shrink(set()): the same world, re-formed at the next epoch.
        group0 = basics.lane().set_groups(0).groups["cuda"]
        epoch1, before = basics.epoch(), phases()
        sync()
        t0 = time.perf_counter()
        kept = hvd.elastic.shrink(set())
        sync()
        out["shrink_ms"] = (time.perf_counter() - t0) * 1e3
        after = phases()
        group1 = basics.lane().set_groups(0).groups["cuda"]
        x = hvd.allreduce(torch.ones(1024, device=dev), name="after.shrink",
                          op=hvd.Sum)
        check(kept and basics.epoch() == epoch1 + 1 and group1 is not group0
              and hvd.size() == 1 and torch.equal(x, torch.ones_like(x)),
              f"shrink(set()): kept {kept}, epoch {basics.epoch()}, new "
              f"group {group1 is not group0}")
        out["shrink_split"] = {k: after.get(k, 0) - before.get(k, 0)
                               for k in ("reinit", "shutdown", "rendezvous",
                                         "nccl_init")}
        out["epoch"] = basics.epoch()
    finally:
        hvd.shutdown()
        for k in ("HOROVOD_REJOIN_PORT", "HOROVOD_CONTROLLER_PORT",
                  "HOROVOD_DEBUG_PORT"):
            del os.environ[k]
    hvd.init()
    try:
        out["poll_us_no_door"] = poll_us()
        _, out["commit_ms_no_door"] = commits()
    finally:
        hvd.shutdown()
    del carry, state
    torch.cuda.empty_cache()
    out.update(state_bytes=state_bytes, reset18_ms=reset18_ms)
    log(f"  door at world size 1: rank 0 hosts a TCP store and the door on "
        f"port {door_port}; /healthz pending_rejoiners 0; the commit poll "
        f"{out['poll_us_door']:.2f} us a call with the door (local at size "
        f"1, no collective), {out['poll_us_no_door']:.2f} us without; "
        f"BERT-Large TreeState commits of {state_bytes / 1e9:.3f} GB "
        f"{[round(x, 1) for x in out['commit_ms_door']]} ms with the door, "
        f"{[round(x, 1) for x in out['commit_ms_no_door']]} ms without; an "
        f"injected HorovodInternalError: restored, reset "
        f"{[round(x, 1) for x in out['fault_reset_ms']]} ms (parole_freeze "
        f"{out['parole_freeze_ms']:.3f} ms, shutdown "
        f"{out['fault_reset_split']['shutdown']:.1f}, init "
        f"{out['fault_reset_split']['rendezvous']:.1f} of it the NCCL "
        f"communicator {out['fault_reset_split']['nccl_init']:.1f}); "
        f"shrink(set()) {out['shrink_ms']:.1f} ms to epoch {out['epoch']} "
        f"with a new NCCL group (reinit "
        f"{out['shrink_split']['reinit']:.1f}: shutdown "
        f"{out['shrink_split']['shutdown']:.1f}, NCCL communicator "
        f"{out['shrink_split']['nccl_init']:.1f}) beside phase 18's resets "
        f"{[round(x, 1) for x in reset18_ms]} ms; card {card}")
    log("  a grown world (1 -> 2) on NCCL is not run: it needs a second "
        "card (NCCL refuses two ranks on one device); the CPU tests grow "
        "worlds of 1, 2 and 3 on gloo")
    return out


def run_lane_tuning(torch, ctr, llama, bert, precision, train_step, cfg,
                    bcfg, card, bound_ms, reset18_ms):
    import horovod_tpu_torch.torch as hvd

    reset_counts(ctr)
    out = dict(autotune=lane_autotune(torch, hvd, llama, cfg, card,
                                      bound_ms),
               door=lane_door(torch, hvd, bert, precision, train_step, bcfg,
                              card, reset18_ms))
    launched = counts(ctr)
    check(not any(n for k, n in launched.items() if k != "Adam"),
          f"phase 19 launched a kernel of K1-K6: {launched}")
    return out


# ---- phase 20: the lane's wire codecs and the cross-plane allreduce ------

CODEC_SOURCE = "horovod_tpu_torch/csrc/wire_codec.cu"
# The reference's host codecs each kernel stands for.
CODEC_REPLACES = {
    "encode_bf16": "csrc/ring_ops.cc:160", "decode_accum_bf16":
    "csrc/ring_ops.cc:168", "decode_scale_bf16": "csrc/ring_ops.cc:178",
    "encode_int8": "csrc/ring_ops.cc:211", "decode_accum_int8":
    "csrc/ring_ops.cc:279", "decode_scale_int8": "csrc/ring_ops.cc:287"}
BUCKET_ELEMS = (64 << 20) // 4     # the lane's 64 MiB fusion buffer, f32
EMU_RANKS, EMU_LOCAL = 4, 2


def codec_specials(torch, n, seed):
    """Seeded values in [-2, 2] with NaN payloads, infinities, signed
    zeros and denormals planted, and an all-zero and an all-denormal
    record where the length allows (phase 2's edge cases for the codecs)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, n).astype(np.float32)
    bits = x.view(np.uint32)
    plant = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001,
             0xFFC12345, 0x7F800001, 0x00000001, 0x807FFFFF, 0x3F808000,
             0x7F7FFFFF]
    for i, b in enumerate(plant[:n]):
        bits[(i * 37) % n] = b
    if n >= 768:
        x[256:512] = 0.0
        bits[512:768] = rng.integers(1, 1 << 23, 256).astype(np.uint32)
    return torch.from_numpy(x)


def same_codec_bits(torch, got, want):
    """Bytes equal; a float result's bits equal wherever the plain value
    is a number and NaN where it is NaN (the card gives arithmetic's NaNs
    its canonical payload)."""
    got, want = got.cpu(), want.cpu()
    if want.dtype != torch.float32:
        return torch.equal(got, want)
    nan = want.isnan()
    return torch.equal(got.isnan(), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def codec_edge_cases(torch, wc):
    """Every codec kernel against its plain version on the edge cases, at
    lengths 0, 1, 255, 256, 257 and 1025, one segment and four."""
    cases = 0
    for n in (0, 1, 255, 256, 257, 1025):
        x = codec_specials(torch, n, 500 + n)
        for codec in (wc.BF16, wc.INT8):
            for nseg in (1, 4):
                seg = wc.Segments.even(n, nseg)
                img = wc.encode(x.cuda(), codec, seg)
                want = wc.encode(x, codec, seg)
                check(same_codec_bits(torch, img, want),
                      f"encode codec {codec} n {n}/{nseg}: bytes differ")
                for post in (1.0, 1.0 / 3.0):
                    got = wc.decode_scale(torch.zeros(n, device="cuda"),
                                          img, codec, seg, post=post)
                    check(same_codec_bits(torch, got, wc.decode_scale(
                        torch.zeros(n), want, codec, seg, post=post)),
                        f"decode_scale codec {codec} n {n}: bits differ")
                m = seg.count(0)
                imgs = torch.cat([wc.encode(codec_specials(torch, m, s),
                                            codec) for s in (1, 2)])
                base = codec_specials(torch, m, 3)
                want = wc.decode_accum(base.clone(), imgs, codec, 2)
                got = wc.decode_accum(base.cuda(), imgs.cuda(), codec, 2)
                check(same_codec_bits(torch, got, want),
                      f"decode_accum codec {codec} n {n}: bits differ")
                cases += 1
    torch.cuda.synchronize()
    return cases


def flagship_buckets(torch, llama, cfg):
    """The flagship's gradient leaves at f32 laid end to end and cut into
    the lane's 64 MiB fusion buckets: the leaves' element counts and the
    buckets'."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    params = llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    sizes = [p.numel() for p in tree_leaves(params)]
    del params
    torch.cuda.empty_cache()
    total = sum(sizes)
    buckets = [BUCKET_ELEMS] * (total // BUCKET_ELEMS)
    if total % BUCKET_ELEMS:
        buckets.append(total % BUCKET_ELEMS)
    return sizes, buckets


def codec_buckets(torch, wc, buckets):
    """Each bucket of the gradient set through every kernel against its
    plain version on the card, as the compressed allreduce of 4 ranks
    cuts it (4 segments; the owner's 3 images; the gathered slots with
    the Average's 1/4): bit for bit; the largest difference per kernel."""
    err = {k: 0.0 for k in wc.KERNELS}
    gen = torch.Generator(device="cuda")
    for i, count in enumerate(buckets):
        x = torch.randn(count, generator=gen.manual_seed(i),
                        device="cuda") * 1e-2
        seg = wc.Segments.even(count, EMU_RANKS)
        for codec in (wc.BF16, wc.INT8):
            name = wc.CODEC_NAMES[codec]
            img = wc.encode(x, codec, seg)
            plain = wc._encode_plain(x, torch.empty_like(img), codec, seg)
            check(torch.equal(img, plain),
                  f"bucket {i}: encode_{name} bytes differ from plain")
            stride = wc.image_len(seg.largest, codec)
            slots = torch.zeros(EMU_RANKS * stride, dtype=torch.uint8,
                                device="cuda")
            pos = 0
            for j in range(EMU_RANKS):
                w = wc.image_len(seg.count(j), codec)
                slots[j * stride:j * stride + w] = img[pos:pos + w]
                pos += w
            got = wc.decode_scale(torch.empty_like(x), slots, codec, seg,
                                  stride, 0.25)
            want = wc._decode_scale_plain(torch.empty_like(x), slots, codec,
                                          seg, stride, 0.25)
            err[f"decode_scale_{name}"] = max(
                err[f"decode_scale_{name}"],
                float((got - want).abs().max()))
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"bucket {i}: decode_scale_{name} bits differ from plain")
            m = seg.count(0)
            own = img[:wc.image_len(m, codec)]
            imgs = torch.cat([own] * (EMU_RANKS - 1))
            got = wc.decode_accum(x[:m].clone(), imgs, codec,
                                  EMU_RANKS - 1)
            want = wc._decode_accum_plain(x[:m].clone(), imgs, codec,
                                          EMU_RANKS - 1)
            err[f"decode_accum_{name}"] = max(
                err[f"decode_accum_{name}"],
                float((got - want).abs().max()))
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"bucket {i}: decode_accum_{name} bits differ from plain")
        del x
    torch.cuda.synchronize()
    return err


def median_ms(torch, fn, reps=15, warmup=2):
    """The median over ``reps`` launches of ``fn``'s device time, one
    pair of CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def codec_timing(torch, wc):
    """Each kernel at its main-path shape on one 64 MiB bucket of 4
    ranks' segments: ms (median of CUDA-event launches) beside the bytes
    bound (each input read once, each output written once), the plain
    version's ms on the same inputs, and one PyTorch call's where one
    computes the same function (bf16 encode: ``to(torch.bfloat16)``)."""
    n = BUCKET_ELEMS
    x = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(
        7), device="cuda") * 1e-2
    seg = wc.Segments.even(n, EMU_RANKS)
    m = seg.count(0)
    rows = {}
    for codec in (wc.BF16, wc.INT8):
        name = wc.CODEC_NAMES[codec]
        img = wc.encode(x, codec, seg)
        wlen = img.numel()
        stride = wc.image_len(seg.largest, codec)
        out = torch.empty_like(x)
        imgs = torch.cat([img[:wc.image_len(m, codec)]] * (EMU_RANKS - 1))
        acc = x[:m].clone()
        cases = {
            f"encode_{name}": (
                lambda: wc.encode(x, codec, seg),
                lambda: wc._encode_plain(x, torch.empty_like(img), codec,
                                         seg),
                4 * n + wlen, f"[{n}] f32 -> {wlen} B, 4 segments"),
            f"decode_scale_{name}": (
                lambda: wc.decode_scale(out, img, codec, seg, 0, 0.25),
                lambda: wc._decode_scale_plain(out, img, codec, seg, 0,
                                               0.25),
                wlen + 4 * n, f"{wlen} B -> [{n}] f32, post 1/4"),
            f"decode_accum_{name}": (
                lambda: wc.decode_accum(acc, imgs, codec, EMU_RANKS - 1),
                lambda: wc._decode_accum_plain(acc, imgs, codec,
                                               EMU_RANKS - 1),
                imgs.numel() + 8 * m,
                f"[{m}] f32 += 3 images of {imgs.numel() // 3} B")}
        for kname, (kernel, plain, nbytes, shape) in cases.items():
            ms = median_ms(torch, kernel)
            plain_ms = median_ms(torch, plain, reps=5, warmup=1)
            b_ms, b_by = bound(nbytes, 0, "float32")
            lib = None
            if kname == "encode_bf16":
                lib = median_ms(torch, lambda: x.to(torch.bfloat16))
            rows[kname] = dict(shape=shape, ms=ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                               bytes=nbytes)
            log(f"  {kname} {shape}: {ms:.4f} ms (bound {b_ms:.4f}, "
                f"{b_ms / ms:.2f} of it; plain {plain_ms:.4f}"
                + (f"; to(bfloat16) {lib:.4f}" if lib is not None else "")
                + ")")
    del x
    torch.cuda.empty_cache()
    return rows


class EmuGroup:
    """One process group of emulated ranks: each collective is a
    rendezvous of its members' threads, and its transport device copies
    (a sum in member order for the exact reductions)."""

    def __init__(self, members, timeout=300):
        import threading

        self.members = list(members)
        self.barrier = threading.Barrier(len(members), timeout=timeout)
        self.calls = [None] * len(members)

    def run(self, rank, name, args, kwargs):
        import torch.distributed as dist

        pos = self.members.index(rank)
        self.calls[pos] = (args, kwargs)
        if self.barrier.wait() == 0:
            import torch

            n = len(self.members)
            if name in ("all_reduce", "reduce_scatter"):
                srcs = [c[0][0 if name == "all_reduce" else 1]
                        for c in self.calls]
                op = kwargs.get("op", dist.ReduceOp.SUM)
                acc = srcs[0].clone()
                for s in srcs[1:]:
                    if op == dist.ReduceOp.SUM:
                        acc += s
                    else:
                        acc = (torch.maximum if op == dist.ReduceOp.MAX
                               else torch.minimum)(acc, s)
                for i, c in enumerate(self.calls):
                    if name == "all_reduce":
                        c[0][0].copy_(acc)
                    else:
                        out = c[0][0]
                        out.copy_(acc.view(n, -1)[i])
            elif name == "all_gather":
                whole = torch.cat([c[0][1] for c in self.calls])
                for c in self.calls:
                    c[0][0].copy_(whole)
            elif name == "all_to_all":
                for i, c in enumerate(self.calls):
                    out = c[0][0]
                    pos_out = 0
                    for j, src in enumerate(self.calls):
                        sizes = src[1]["input_split_sizes"]
                        off = sum(sizes[:i])
                        out[pos_out:pos_out + sizes[i]].copy_(
                            src[0][1][off:off + sizes[i]])
                        pos_out += sizes[i]
            else:
                raise SmokeFailure(f"emulated {name} not supported")
        self.barrier.wait()


def emulated_allreduce(torch, inputs, split, codec, cross, op="sum"):
    """The data plane's allreduce of ``inputs`` (one 1-D tensor a rank,
    on one device) over EMU_RANKS emulated ranks, each a thread with its
    own ``DataPlane``: the hierarchy split ``split`` (slices of
    EMU_LOCAL), ``codec`` on every hop, bf16 on the cross hop under
    ``cross``; only the transport is replaced (:class:`EmuGroup`).
    Returns each rank's result."""
    import threading

    from horovod_tpu_torch.common.data_plane import DataPlane
    from horovod_tpu_torch.common.message import ReduceOp
    from horovod_tpu_torch.common.operations import SetGroups

    n = len(inputs)
    dev = "cuda" if inputs[0].is_cuda else "cpu"
    world = EmuGroup(range(n))
    slices = [EmuGroup(range(i, i + EMU_LOCAL))
              for i in range(0, n, EMU_LOCAL)]
    crosses = [EmuGroup(range(j, n, EMU_LOCAL)) for j in range(EMU_LOCAL)]
    results, errors = [None] * n, []
    rop = {"sum": ReduceOp.SUM, "average": ReduceOp.AVERAGE}[op]

    def rank_fn(rank):
        try:
            plane = DataPlane(None, 64 << 20, world=n)
            plane._dev = dev
            plane.wire_codec, plane.cross_compression = codec, cross
            plane.hier_split = split
            local = slices[rank // EMU_LOCAL]
            cgroup = crosses[rank % EMU_LOCAL]
            plane.hier_groups = {EMU_LOCAL: (
                SetGroups(local.members, rank, {dev: local}),
                SetGroups(cgroup.members, rank, {dev: cgroup}))}
            plane._collective = lambda pg, name, fn, *a, **k: pg.run(
                rank, name, a, k)
            buf = inputs[rank].clone()
            post = 1.0 / n if rop == ReduceOp.AVERAGE else 1.0
            plane._allreduce_buf(buf, rop, post, world, n, rank,
                                 SetGroups(range(n), rank, {dev: world}))
            results[rank] = buf
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(f"rank {rank}: {type(e).__name__}: {e}")
            for g in [world] + slices + crosses:
                g.barrier.abort()

    threads = [threading.Thread(target=rank_fn, args=(r,))
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise SmokeFailure("emulated allreduce failed: " + "; ".join(errors))
    if dev == "cuda":
        torch.cuda.synchronize()
    return results


# (label, split, codec, cross compression)
EMU_MODES = [("flat", 0, 0, False), ("hier", EMU_LOCAL, 0, False),
             ("flat bf16", 0, 1, False), ("flat int8", 0, 2, False),
             ("hier bf16", EMU_LOCAL, 1, False),
             ("hier int8", EMU_LOCAL, 2, False),
             ("hier cross-only bf16", EMU_LOCAL, 0, True),
             ("hier int8 + cross bf16", EMU_LOCAL, 2, True)]


def run_emulated(torch, wc):
    """(b) The data plane's flat, hierarchical and compressed allreduces
    over 4 emulated ranks (2 x 2) on the card: exact fills bit-identical
    to the flat sum uncompressed; every mode bitwise across the ranks and
    within the envelope (N^2 2^-7 bf16, N^2 2^-6 int8 on [-2, 2]) on a
    64 MiB bucket a rank; the same run on the CPU's plain versions at
    1 M + 37 elements a rank gives the same bits; each codec kernel
    launched (the counts, set to 0 before, read after)."""
    n = EMU_RANKS
    gen = torch.Generator(device="cuda")
    exact = [torch.from_numpy(((np.arange(4099) % 9 - 4) * (r + 1)).astype(
        np.float32)).cuda() for r in range(n)]
    want_exact = sum(x.double() for x in exact).float()
    big = [torch.rand(BUCKET_ELEMS, generator=gen.manual_seed(40 + r),
                      device="cuda") * 4 - 2 for r in range(n)]
    want_big = sum(x.double() for x in big)
    small = [torch.from_numpy(np.random.default_rng([41, r]).uniform(
        -2, 2, (1 << 20) + 37).astype(np.float32)) for r in range(n)]
    for k in wc.KERNELS:
        wc.launches[k] = 0
    out = {}
    for label, split, codec, cross in EMU_MODES:
        res = emulated_allreduce(torch, exact, split, codec, cross)
        if codec == 0 and not cross:
            check(all(torch.equal(r, want_exact) for r in res),
                  f"emulated {label}: exact fill not the flat sum")
        t0 = time.perf_counter()
        res = emulated_allreduce(torch, big, split, codec, cross)
        ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.equal(r.view(torch.int32), res[0].view(torch.int32))
                  for r in res), f"emulated {label}: ranks disagree")
        err = float((res[0].double() - want_big).abs().max())
        hops = max(codec, 1 if cross else 0)
        limit = n * n * (2.0 ** -7 if hops == 1 else 2.0 ** -6) if hops \
            else 1e-5
        check(err <= limit, f"emulated {label}: max error {err} > {limit}")
        card = emulated_allreduce(torch, [x.cuda() for x in small], split,
                                  codec, cross, op="average")
        host = emulated_allreduce(torch, small, split, codec, cross,
                                  op="average")
        check(all(torch.equal(c.cpu().view(torch.int32),
                              h.view(torch.int32))
                  for c, h in zip(card, host)),
              f"emulated {label}: the card's bits differ from the CPU's")
        out[label] = dict(max_abs_err=err, limit=limit, host_ms=ms)
        log(f"  emulated {label}: 4 ranks x {BUCKET_ELEMS} f32, max error "
            f"{err:.3e} (limit {limit:.3e}), {ms:.1f} ms host; card == CPU "
            "bits at 1 M + 37")
    launches = {k: wc.launches[k] for k in wc.KERNELS}
    check(all(launches.values()),
          f"emulated compressed allreduces: a codec kernel never launched "
          f"{launches}")
    return out, launches


def lane_wire_at_one(torch, hvd, llama, cfg, sizes, wc):
    """(c) The lane at world size 1 on NCCL under
    ``HOROVOD_CROSS_PLANE=hier`` and ``HOROVOD_WIRE_COMPRESSION=int8``:
    the rank-0 warning, split 0, the modes in ``metrics()["knobs"]``; an
    f32 grouped set of the flagship's first leaves bit-identical to the
    run without the settings (the reference does not round at size 1);
    ``wire`` bytes 0 and no codec launch."""
    import io

    from horovod_tpu_torch.common import basics

    gen = torch.Generator(device="cuda").manual_seed(11)
    leaves = [torch.randn(s, generator=gen, device="cuda")
              for s in sizes[:40]]
    results, info = {}, {}
    for label, env in (("settings", {"HOROVOD_CROSS_PLANE": "hier",
                                     "HOROVOD_WIRE_COMPRESSION": "int8"}),
                       ("plain", {})):
        saved = {k: os.environ.get(k) for k in (
            "HOROVOD_CROSS_PLANE", "HOROVOD_WIRE_COMPRESSION")}
        os.environ.update(env)
        err, old = io.StringIO(), sys.stderr
        sys.stderr = err
        try:
            hvd.init()
        finally:
            sys.stderr = old
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        try:
            hvd.metrics_reset()
            before = dict(wc.launches)
            grads = [g.clone() for g in leaves]
            hvd.grouped_allreduce_(grads, op=hvd.Average)
            torch.cuda.synchronize()
            results[label] = grads
            snap = hvd.metrics()
            info[label] = dict(
                warning=err.getvalue().strip(), split=hvd.hier_split(),
                knobs={k: snap["knobs"][k] for k in (
                    "cross_plane", "wire_codec", "hier_split",
                    "cross_compression")},
                tx_bytes=snap["wire"]["tx_bytes"],
                codec_launches=sum(wc.launches[k] - before[k]
                                   for k in wc.KERNELS),
                world=basics.size())
        finally:
            hvd.shutdown()
    s = info["settings"]
    check("HOROVOD_CROSS_PLANE=hier disabled" in s["warning"],
          f"no hier warning at world size 1: {s['warning']!r}")
    check(s["split"] == 0 and s["knobs"]["cross_plane"] == "hier" and
          s["knobs"]["wire_codec"] == "int8" and s["world"] == 1,
          f"world size 1 under hier/int8: {s}")
    check(info["plain"]["knobs"]["cross_plane"] == "auto",
          f"plain knobs {info['plain']}")
    check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
              for a, b in zip(results["settings"], results["plain"])),
          "world size 1: the settings changed an f32 result")
    check(s["tx_bytes"] == 0 and s["codec_launches"] == 0,
          f"world size 1 moved wire bytes or launched a codec: {s}")
    log(f"  world size 1, hier + int8: warning {s['warning']!r}; split "
        f"{s['split']}; knobs {s['knobs']}; {len(leaves)} f32 leaves "
        "bit-identical to the plain run; wire bytes 0, no codec launch")
    return info


def run_wire(torch, llama, cfg, card):
    """Phase 20."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.ops import wire_codec as wc

    edge = codec_edge_cases(torch, wc)
    log(f"  codec kernels == plain on {edge} edge cases (NaN payloads, "
        "infinities, denormals, empty and all-zero records)")
    sizes, buckets = flagship_buckets(torch, llama, cfg)
    err = codec_buckets(torch, wc, buckets)
    log(f"  flagship f32 gradient set: {len(sizes)} leaves, "
        f"{sum(sizes) / 1e9:.3f} B elements in {len(buckets)} buckets of "
        f"64 MiB: every kernel == plain bit for bit; card {card}")
    timing = codec_timing(torch, wc)
    emulated, launches = run_emulated(torch, wc)
    lane = lane_wire_at_one(torch, hvd, llama, cfg, sizes, wc)
    return dict(edge_cases=edge, buckets=len(buckets),
                elements=sum(sizes), err=err, timing=timing,
                emulated=emulated, launches=launches, lane=lane)


def codec_rows(wire):
    """The codec kernels' rows of the ``kernels`` line."""
    rows = []
    for k in ("encode_bf16", "decode_accum_bf16", "decode_scale_bf16",
              "encode_int8", "decode_accum_int8", "decode_scale_int8"):
        t = wire["timing"][k]
        rows.append(dict(
            name=f"wire {k}", route="cuda", source=CODEC_SOURCE,
            replaces=CODEC_REPLACES[k], launches=wire["launches"][k],
            max_abs_err=wire["err"].get(k, 0.0), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            shape=t["shape"]))
    return rows


# ---- phase 21: the port's launcher on the card ---------------------------

LAUNCH_STEPS = 3
WORKER_FLAG = "--launched-worker"
LAUNCH_TIMEOUT_S = 420


class AveragedAdam:
    """``fused_adam`` whose apply first averages the step's gradients on
    the lane: one ``grouped_allreduce_async_`` Average of every leaf."""

    def __init__(self, hvd, inner):
        self.hvd, self.inner = hvd, inner

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, opt):
        from horovod_tpu_torch.parallel._tree import tree_leaves

        for h in self.hvd.grouped_allreduce_async_(tree_leaves(grads),
                                                   op=self.hvd.Average):
            h.synchronize()
        return self.inner.apply(params, grads, opt)


def params_digest(torch, params):
    """sha256 of the params' bytes, leaf by leaf, read back to the host."""
    import hashlib

    from horovod_tpu_torch.parallel._tree import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(params):
        h.update(t.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def bert_lane_job(torch, hvd, bert, precision, train_step, cfg, on_step,
                  elastic=False):
    """Phase 13's BERT-Large step (B16 x T512, seeded padding,
    ``fused_adam(1e-4)``, full remat) on the split step, each step's
    gradients one Average on the lane: ``LAUNCH_STEPS`` steps, plainly
    or under ``hvd.elastic.run`` with a ``TreeState`` committed every
    step. ``on_step(step, state)`` runs after each step (after its
    commit). Returns (losses, step ms, digest of the final params)."""
    data = bert_batch(torch, cfg, 16, 512, 40)
    ts = train_step.make_split_train_step(
        lambda p, d: bert.bert_mlm_loss(p, d, cfg),
        AveragedAdam(hvd, precision.fused_adam(1e-4)))
    carry = ts.init(bert.bert_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    losses, step_ms = [], []

    def one(carry):
        t0 = time.perf_counter()
        loss, carry = ts.step(carry, data)
        losses.append(float(loss))   # reads back: the step has ended
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return carry

    if not elastic:
        for step in range(LAUNCH_STEPS):
            carry = one(carry)
            on_step(step + 1, None)
        return losses, step_ms, params_digest(torch, carry[0])
    state = hvd.elastic.TreeState(carry=carry, step=0)
    del carry

    @hvd.elastic.run
    def train(state):
        while state.step < LAUNCH_STEPS:
            state.carry = one(state.carry)
            state.step += 1
            state.commit()
            on_step(state.step, state)

    train(state)
    return losses, step_ms, params_digest(torch, state.carry[0])


def launched_worker(mode, out):
    """A rank of phase 21's launched job (``chip_smoke.py
    --launched-worker static|elastic OUT``): the lane on the card the
    launcher's layout gives it, ``bert_lane_job``, its results in
    ``OUT/rank<r>.json``. Under ``elastic``, rank 0's first attempt
    exits 17 after step 1's commit, marked by ``OUT/fault.json``."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import bert
    from horovod_tpu_torch.ops import adam
    from horovod_tpu_torch.ops import decode_attention as da
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import grouped_moe as gm
    from horovod_tpu_torch.parallel import precision, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctr = launch_counters(fa, da, gm, adam)
    reset_counts(ctr)
    hvd.init()
    record = dict(device=torch.cuda.current_device(), pid=os.getpid())
    card = basics.card_index(hvd.local_rank())
    check(record["device"] == card,
          f"rank {hvd.rank()}: current device {record['device']}, its card "
          f"{card} (local rank {hvd.local_rank()})")
    marker = os.path.join(out, "fault.json")

    def on_step(step, state):
        record.setdefault("first_step_at", time.time())
        if mode == "elastic" and hvd.rank() == 0 and step == 1 \
                and not os.path.exists(marker):
            with open(marker, "w") as f:
                json.dump({"exit_at": time.time(),
                           "first_step_at": record["first_step_at"]}, f)
            os._exit(17)

    cfg = bert.BertConfig.large()
    losses, step_ms, digest = bert_lane_job(
        torch, hvd, bert, precision, train_step, cfg, on_step,
        elastic=mode == "elastic")
    # A survivor of a re-formation may hold another rank than it began
    # with: record the last epoch's layout.
    rank = hvd.rank()
    record.update(rank=rank, local_rank=hvd.local_rank(), size=hvd.size(),
                  losses=losses, step_ms=step_ms, digest=digest,
                  launches=counts(ctr), bias_launches=bias_counts(ctr))
    hvd.shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def run_launcher_cmd(root, env, argv, timeout=LAUNCH_TIMEOUT_S):
    """``python -m horovod_tpu_torch.runner.launch argv`` from the
    checkout's root: (return code, stdout, stderr). On timeout the
    launcher gets SIGTERM, which takes its ranks down, then SIGKILL."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *argv],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        raise SmokeFailure(f"launcher {argv[:4]} timed out after {timeout} "
                           f"s; stderr tail: {err[-3000:]}")
    return proc.returncode, out, err


def launched_results(out, n):
    ranks = []
    for r in range(n):
        path = os.path.join(out, f"rank{r}.json")
        check(os.path.exists(path), f"launched rank {r} wrote no result")
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks


def check_launched(ranks, n, cfg, want_losses, want_digest, label,
                   elastic=False):
    """Every rank on its card, with the same final params; the kernels
    launched in the child (per step K1 2L, K2 = K3 L, all biased). At
    N = 1 the losses and the params' digest are the in-process run's bit
    for bit; more ranks average N equal gradients, which rounds, so
    there the losses agree with it to 1e-3. Under ``elastic`` a rank's
    losses are the steps it ran: a respawned rank's, the tail."""
    L = cfg.n_layers
    for r, g in enumerate(ranks):
        check(g["rank"] == r and g["local_rank"] == r and g["size"] == n
              and (elastic or g["device"] == r),
              f"{label}: rank {r} layout {g}")
        check(g["digest"] == ranks[0]["digest"],
              f"{label}: rank {r}'s final params differ from rank 0's")
        steps = len(g["losses"])
        check(0 < steps <= LAUNCH_STEPS and (elastic or steps ==
                                             LAUNCH_STEPS),
              f"{label}: rank {r} ran {steps} steps")
        want = want_losses[-steps:]
        if n == 1:
            check(g["losses"] == want,
                  f"{label}: losses {g['losses']} are not the in-process "
                  f"run's {want} bit for bit")
        else:
            check(all(abs(a - b) <= 1e-3 * abs(b)
                      for a, b in zip(g["losses"], want)),
                  f"{label}: rank {r} losses {g['losses']} vs {want}")
        for k, per in {"K1": 2 * L, "K2": L, "K3": L}.items():
            got, biased = g["launches"][k], g["bias_launches"][k]
            check(got == biased and (got == per * steps if not elastic
                                     else got >= per * steps),
                  f"{label}: rank {r} {k} launched {got} times ({biased} "
                  f"with the bias) in {steps} steps, {per} a step")
    if n == 1:
        check(ranks[0]["digest"] == want_digest,
              f"{label}: final params digest {ranks[0]['digest']} is not "
              f"the in-process run's {want_digest}")


def run_launcher_phase(torch, bert, precision, train_step, cfg, card,
                       step13_ms):
    """The port's launcher on the card: (a) ``--check-build``; (b) a
    static ``--local-cards`` launch of ``LAUNCH_STEPS`` BERT-Large steps
    on the lane, held bit for bit against the same steps in this
    process; (c) the same job under the port's ``ElasticDriver``
    (``--min-np 1 --max-np N``, a discovery script printing
    ``localhost:N``), rank 0's first attempt failing after step 1 and
    its slot respawned; (d) the launch-to-first-step, step and respawn
    times."""
    import tempfile

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.common.capabilities import nccl_version_string

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    n = torch.cuda.device_count()
    out = {"cards": n}

    t0 = time.perf_counter()
    rc, text, err = run_launcher_cmd(root, env, ["--check-build"], 120)
    out["check_build_s"] = time.perf_counter() - t0
    check(rc == 0, f"--check-build exited {rc}: {err[-2000:]}")
    nccl = nccl_version_string()
    for row in (f"[X] NCCL {nccl}", "[X] gloo",
                f"[X] CUDA {torch.version.cuda}", "[X] TCP rendezvous"):
        check(row in text, f"--check-build lacks {row!r}:\n{text}")
    out["check_build"] = text
    log("  (a) --check-build: " + "; ".join(
        line.strip() for line in text.splitlines() if "[" in line))

    def in_process():
        hvd.init(device="cuda")
        try:
            return bert_lane_job(torch, hvd, bert, precision, train_step,
                                 cfg, lambda step, state: None)
        finally:
            hvd.shutdown()

    want_losses, in_ms, want_digest = in_process()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["in_process"] = dict(losses=want_losses, step_ms=in_ms,
                             digest=want_digest)
    built = sorted(os.listdir(_build.BUILD_DIR))
    worker = [sys.executable, os.path.join(root, "chip_smoke.py"),
              WORKER_FLAG]
    with tempfile.TemporaryDirectory() as tmp:
        static_dir = os.path.join(tmp, "static")
        os.mkdir(static_dir)
        t_launch = time.time()
        rc, text, err = run_launcher_cmd(
            root, env, ["--local-cards", *worker, "static", static_dir])
        static_s = time.time() - t_launch
        check(rc == 0, f"(b) the --local-cards launch exited {rc}: "
              f"{err[-4000:]}")
        ranks = launched_results(static_dir, n)
        check_launched(ranks, n, cfg, want_losses, want_digest, "(b)")
        static = dict(
            wall_s=static_s,
            launch_to_first_step_s=ranks[0]["first_step_at"] - t_launch,
            step_ms=ranks[0]["step_ms"],
            median_step_ms=float(np.median(ranks[0]["step_ms"])),
            launches=ranks[0]["launches"], digest=ranks[0]["digest"])

        elastic_dir = os.path.join(tmp, "elastic")
        os.mkdir(elastic_dir)
        discovery = os.path.join(tmp, "discover.sh")
        with open(discovery, "w") as f:
            f.write(f"#!/bin/sh\necho localhost:{n}\n")
        os.chmod(discovery, 0o755)
        t_launch = time.time()
        rc, text, err = run_launcher_cmd(
            root, env, ["--min-np", "1", "--max-np", str(n),
                        "--host-discovery-script", discovery,
                        "--elastic-poll-interval", "0.5", *worker,
                        "elastic", elastic_dir])
        elastic_s = time.time() - t_launch
        check(rc == 0, f"(c) the elastic launch exited {rc}: {err[-4000:]}")
        marker = os.path.join(elastic_dir, "fault.json")
        check(os.path.exists(marker),
              "(c) rank 0's first attempt never failed")
        with open(marker) as f:
            fault = json.load(f)
        ranks = launched_results(elastic_dir, n)
        check_launched(ranks, n, cfg, want_losses, want_digest, "(c)",
                       elastic=True)
        check(ranks[0]["digest"] == static["digest"],
              "(c) the elastic job's final params differ from (b)'s")
        respawn = [g for g in ranks if g["first_step_at"] > fault["exit_at"]]
        check(respawn, "(c) no rank started after the failed attempt")
        elastic = dict(
            wall_s=elastic_s,
            launch_to_first_step_s=fault["first_step_at"] - t_launch,
            respawn_s=min(g["first_step_at"] for g in respawn)
            - fault["exit_at"], losses=ranks[0]["losses"],
            digest=ranks[0]["digest"])
    check(sorted(os.listdir(_build.BUILD_DIR)) == built,
          "a launched rank built a kernel library: the children must load "
          "the ones this run built")
    out.update(static=static, elastic=elastic)
    same = "bit-identical to" if n == 1 else "within 1e-3 of"
    log(f"  (b) --local-cards, {n} rank(s): {LAUNCH_STEPS} steps, losses "
        f"{want_losses} {same} the in-process run's (digest "
        f"{want_digest[:16]}); launch to first "
        f"step {static['launch_to_first_step_s']:.2f} s, whole launch "
        f"{static['wall_s']:.2f} s; step ms "
        f"{[round(x, 1) for x in static['step_ms']]} (median "
        f"{static['median_step_ms']:.1f}; in-process "
        f"{[round(x, 1) for x in in_ms]}; phase 13 {step13_ms:.1f}); "
        f"child launches {static['launches']}; card {card}")
    log(f"  (c) elastic (--min-np 1 --max-np {n}): the failed attempt's "
        f"slot respawned, final digest equal to (b)'s; launch to first "
        f"step {elastic['launch_to_first_step_s']:.2f} s, worker exit to "
        f"its replacement's first step {elastic['respawn_s']:.2f} s, whole "
        f"launch {elastic['wall_s']:.2f} s; card {card}")
    return out


# ---- phase 22: ZeRO-1 on both lanes ------------------------------------

ZERO_LR = 3e-4


def same_tree_bits(torch, got, want):
    """Whether two trees of tensors hold the same bits (``want`` may lie
    on the host)."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.detach().reshape(-1).view(torch.uint8),
            y.to(x.device).reshape(-1).view(torch.uint8))
        for x, y in zip(a, b))


def to_host(torch, tree):
    """A copy of a tree (dicts, tuples, namedtuples of tensors) on the
    host."""
    if isinstance(tree, dict):
        return {k: to_host(torch, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [to_host(torch, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    if isinstance(tree, list):
        return [to_host(torch, v) for v in tree]
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def zero_state_matches(torch, layout, zstate, rstate, master_dtype=None):
    """Whether a world-size-1 ZeRO state holds the replicated state's
    bits, packed into the layout's buckets."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    fields = ["mu", "nu"] + (["master"] if master_dtype else [])
    for f in fields:
        zs = getattr(zstate, f) if hasattr(zstate, f) else zstate[f]
        leaves = [t.to(zs[0].device) for t in tree_leaves(
            getattr(rstate, f) if hasattr(rstate, f) else rstate[f])]
        for i, z in enumerate(zs):
            want = layout.pack_bucket(leaves, i, master_dtype)
            if not torch.equal(z.view(torch.uint8), want.view(torch.uint8)):
                return False
    return True


def timed_steps(torch, step, carry, data, steps):
    """``steps`` calls of ``step``, each synchronized: (losses, carry,
    seconds per step)."""
    losses, secs = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, carry = step(carry, data)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.detach().clone())
    return losses, carry, secs


def zero_split_runs(torch, ctr, llama, precision, train_step, fusion, Z,
                    cfg, data, kind, total, steps=3):
    """Phase 22 (a) or (b): the replicated split step, then ZeRO-1 at
    world size 1 unfused and fused, each from the same seeded params;
    losses, params and state bit for bit against the replicated run."""
    make_opt = {"adam": lambda: precision.fused_adam(ZERO_LR),
                "master": lambda: precision.fused_master_adam(ZERO_LR)}[kind]
    pcfg = cfg if kind == "adam" else dataclasses.replace(
        cfg, param_dtype="float32")
    runs, ref = {}, None
    for name, zero, fused in (
            ("replicated", None, True),
            ("zero unfused", Z.ZeroConfig(size=1), False),
            ("zero fused", Z.ZeroConfig(size=1), True)):
        fusion.set_jit_fusion(fused)
        try:
            ts = train_step.make_split_train_step(
                lambda p, d: llama.llama_loss(p, d, pcfg), make_opt(),
                zero=zero)
            carry = ts.init(llama.llama_init(
                pcfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda"))
            torch.cuda.reset_peak_memory_stats()
            reset_counts(ctr)
            losses, carry, secs = timed_steps(torch, ts.step, carry, data,
                                              steps)
            launched = counts(ctr)
            check_wgmma_routes(ctr, f"phase 22 {kind} {name}")
            if zero is None:
                per_step = len(Z.tree_leaves(carry[0]))
            else:
                layout = Z.zero_bucket_layout(
                    Z.layout_leaves(Z._optimizer_hyper(make_opt()),
                                    carry[0]), 1, Z.DEFAULT_BUCKET_BYTES)
                per_step = sum(-(-b.shard_elems(1) // Z.ADAM_CHUNK)
                               for b in layout.buckets)
            check_adam(ctr, f"phase 22 {kind} {name}", per_step, steps,
                       variant=kind)
            total["Adam " + kind] += launched["Adam"]
        finally:
            fusion.set_jit_fusion(None)
        for k in ("K1", "K2", "K3"):
            check(launched[k] == cfg.n_layers * steps,
                  f"phase 22 {kind} {name}: {k} launched {launched[k]} "
                  f"times in {steps} steps")
            total[k] += launched[k]
        loss_bits = [int(x.view(torch.int32)) for x in losses]
        row = dict(ms_per_step=float(np.mean(secs[1:])) * 1e3,
                   first_step_ms=secs[0] * 1e3,
                   losses=[float(x) for x in losses], launches=launched,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   state_bytes=Z.optimizer_state_bytes(carry[1]))
        if ref is None:
            ref = (loss_bits, to_host(torch, carry))
        else:
            check(loss_bits == ref[0],
                  f"phase 22 {kind} {name}: losses {row['losses']} differ "
                  f"from the replicated step's bits")
            check(same_tree_bits(torch, carry[0], ref[1][0]),
                  f"phase 22 {kind} {name}: params differ from the "
                  "replicated step's bits")
            layout = Z.zero_bucket_layout(
                Z.layout_leaves(Z._optimizer_hyper(make_opt()), carry[0]),
                1, Z.DEFAULT_BUCKET_BYTES)
            check(zero_state_matches(
                torch, layout, carry[1], ref[1][1],
                torch.float32 if kind == "master" else None),
                f"phase 22 {kind} {name}: the state differs from the "
                "replicated state's bits")
            row["bit_identical"] = True
        runs[name] = row
        del carry
        torch.cuda.empty_cache()
    return runs


def zero_lane_applies(torch, hvd, llama, precision, train_step, Z, cfg,
                      data, reps=10):
    """Phase 22 (c): ``hvd.DistributedFusedAdam`` on NCCL over the
    flagship's bf16 gradients against ``fused_adam``'s apply."""
    from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map

    params = llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    _, grads = train_step._value_and_grad(
        lambda p, d: llama.llama_loss(p, d, cfg), params, data, 1)

    def clone(tree):
        return tree_map(lambda t: t.clone(), tree)

    def timed(apply, p, g, s):
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, s = apply(p, g, s)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return float(np.median(secs)) * 1e3

    ref_opt = precision.fused_adam(ZERO_LR)
    ref_p = clone(params)
    ref_s = ref_opt.init(ref_p)
    ref_p, ref_s = ref_opt.apply(ref_p, grads, ref_s)
    out = {"fused_adam": {"ms_per_apply": timed(
        ref_opt.apply, clone(ref_p), grads, ref_opt.init(ref_p))}}
    layout = Z.zero_bucket_layout(tree_leaves(params), 1,
                                  Z.DEFAULT_BUCKET_BYTES)
    for name, kw in (("zero=True overlap", dict(zero=True)),
                     ("zero=True overlap=False",
                      dict(zero=True, overlap=False)),
                     ("zero=False", {})):
        opt = hvd.DistributedFusedAdam(ZERO_LR, **kw)
        p = clone(params)
        s = opt.init(p)
        hvd.metrics_reset()
        p, s = opt.apply(p, clone(grads), s)
        torch.cuda.synchronize()
        ops = hvd.metrics()["device_ops"]
        check(same_tree_bits(torch, p, ref_p),
              f"phase 22 (c) {name}: params differ from fused_adam's bits")
        if kw.get("zero"):
            check(zero_state_matches(torch, layout, s, ref_s),
                  f"phase 22 (c) {name}: state differs from fused_adam's")
            n = len(layout.buckets)
            check(ops.get("reducescatter", {}).get("tensors") == n and
                  ops.get("allgather", {}).get("tensors") == n and
                  ops.get("allreduce", {}).get("tensors", 0) == 0,
                  f"phase 22 (c) {name}: lane ops {ops}, expected {n} "
                  "reducescatters and allgathers and no allreduce")
        else:
            check(same_tree_bits(torch, s.mu, ref_s.mu) and
                  same_tree_bits(torch, s.nu, ref_s.nu),
                  f"phase 22 (c) {name}: state differs from fused_adam's")
        ms = timed(opt.apply, p, clone(grads) if not kw else grads, s)
        out[name] = dict(ms_per_apply=ms, ops={
            k: v for k, v in ops.items() if v.get("tensors")},
            state_bytes=Z.optimizer_state_bytes(s), bit_identical=True)
        del p, s
        torch.cuda.empty_cache()
    out["buckets"] = len(layout.buckets)
    return out


def zero_fused_train_step(torch, ctr, hvd, llama, fusion, cfg, data, total,
                          want_losses, steps=3):
    """Phase 22 (d): ``hvd.make_fused_train_step`` on the flagship, fused
    (hooks, allgathers in flight into the next step) and unfused."""
    init, step, finish = hvd.make_fused_train_step(
        lambda p, d: llama.llama_loss(p, d, cfg), ZERO_LR)
    out, ref = {}, None
    for fused in (True, False):
        fusion.set_jit_fusion(fused)
        try:
            carry = init(llama.llama_init(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda"))
            reset_counts(ctr)
            losses, carry, secs = timed_steps(torch, step, carry, data,
                                              steps)
            lagging = carry[2] is not None
            params, carry = finish(carry)
            torch.cuda.synchronize()
            launched = counts(ctr)
            check_wgmma_routes(ctr, "phase 22 (d)")
        finally:
            fusion.set_jit_fusion(None)
        for k in ("K1", "K2", "K3"):
            check(launched[k] == cfg.n_layers * steps,
                  f"phase 22 (d): {k} launched {launched[k]} times")
            total[k] += launched[k]
        check(lagging == fused, f"phase 22 (d) fused={fused}: allgathers "
              f"in flight after a step: {lagging}")
        bits = [int(x.view(torch.int32)) for x in losses]
        label = "fused" if fused else "unfused"
        if ref is None:
            ref = (bits, to_host(torch, params))
        else:
            check(bits == ref[0] and same_tree_bits(torch, params, ref[1]),
                  "phase 22 (d): unfused losses or params differ from the "
                  "fused step's bits")
        check(bits == want_losses, f"phase 22 (d) {label}: losses "
              f"{[float(x) for x in losses]} differ from (a)'s replicated "
              "split step")
        out[label] = dict(ms_per_step=float(np.mean(secs[1:])) * 1e3,
                          first_step_ms=secs[0] * 1e3,
                          losses=[float(x) for x in losses],
                          launches=launched)
        del carry, params
        torch.cuda.empty_cache()
    return out


def gloo_reduce_scatter(torch, hvd):
    """Phase 22 (e): the lane's reducescatter on gloo (CPU tensors) in
    f32 and bf16, on this machine's torch."""
    hvd.init(device="cpu")
    try:
        got = {}
        for dt in (torch.float32, torch.bfloat16):
            x = torch.arange(24, dtype=torch.float32).reshape(6, 4).to(dt)
            out = hvd.reducescatter(x, name=f"rs.{dt}", op=hvd.Sum)
            check(torch.equal(out, x), f"gloo reducescatter {dt}: {out}")
            got[str(dt).removeprefix("torch.")] = "ok"
        return got
    finally:
        hvd.shutdown()


def run_zero_phase(torch, ctr, llama, precision, train_step, cfg, card):
    """Phase 22: ZeRO-1 on the jit lane and on the eager lane."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.parallel import fusion
    from horovod_tpu_torch.parallel import zero as Z

    t_phase = time.perf_counter()
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        4, 2048)).astype(np.int32)).cuda()
    data = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    total = {k: 0 for k in ctr}
    total.update({"Adam adam": 0, "Adam master": 0})
    split = {}
    for kind in ("adam", "master"):
        split[kind] = zero_split_runs(torch, ctr, llama, precision,
                                      train_step, fusion, Z, cfg, data,
                                      kind, total)
        log(f"  ({'a' if kind == 'adam' else 'b'}) flagship B4 T2048 "
            f"{'fused_adam' if kind == 'adam' else 'fused_master_adam'} "
            "(3e-4), 3 steps: " + "; ".join(
                f"{n} {r['ms_per_step']:.1f} ms/step (first "
                f"{r['first_step_ms']:.0f} ms, peak {r['peak_gib']:.2f} "
                f"GiB, state {r['state_bytes'] / 1e9:.3f} GB)"
                for n, r in split[kind].items())
            + f"; losses {split[kind]['replicated']['losses']}, ZeRO "
            "bit-identical to the replicated step (losses, params, "
            f"state); K1-K3 {cfg.n_layers} each per grad call; card {card}")
    want = [int(np.float32(x).view(np.int32))
            for x in split["adam"]["replicated"]["losses"]]
    hvd.init()
    try:
        lane = zero_lane_applies(torch, hvd, llama, precision, train_step,
                                 Z, cfg, data)
        log("  (c) hvd.DistributedFusedAdam on NCCL over the flagship's "
            f"bf16 gradients ({lane['buckets']} buckets), ms per apply "
            "(median of 10): " + "; ".join(
                f"{n} {r['ms_per_apply']:.2f}" for n, r in lane.items()
                if isinstance(r, dict))
            + "; every variant bit-identical to fused_adam; zero=True ops "
            f"{lane['zero=True overlap']['ops']}")
        fused = zero_fused_train_step(torch, ctr, hvd, llama, fusion, cfg,
                                      data, total, want)
        log("  (d) hvd.make_fused_train_step, flagship B4 T2048: " +
            "; ".join(f"{n} {r['ms_per_step']:.1f} ms/step (first "
                      f"{r['first_step_ms']:.0f} ms)"
                      for n, r in fused.items())
            + "; fused == unfused == (a)'s replicated losses bit for bit")
    finally:
        hvd.shutdown()
    gloo = gloo_reduce_scatter(torch, hvd)
    log(f"  (e) gloo reducescatter on torch {torch.__version__}: {gloo}")
    secs = time.perf_counter() - t_phase
    log(f"  phase 22: {secs:.1f} s; K1-K3 launches {total}")
    return total, dict(split=split, lane=lane, fused_train_step=fused,
                       gloo_reduce_scatter=gloo, seconds=secs,
                       launches=total)


# ---- phase 23: the Adam update as one kernel --------------------------------

ADAM_HYPER = (3e-4, 0.9, 0.999, 1e-8)
ADAM_FLOPS = 14          # f32 operations an element (mul, add, div, sqrt)
# (label, variant, p/mu/nu dtype, g (and cast) dtype)
ADAM_VARIANTS = (("bf16", "adam", "bfloat16", "bfloat16"),
                 ("f32", "adam", "float32", "float32"),
                 ("f32 master, bf16 g", "master", "float32", "bfloat16"),
                 ("f32 master, f32 g", "master", "float32", "float32"))


def adam_leaf_inputs(torch, shape, p_dtype, g_dtype, seed, offset=0):
    """p, g, mu, nu as views ``offset`` elements into larger buffers,
    random values of an Adam state's magnitudes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))

    def view(dtype, scale, positive=False):
        t = torch.randn(n + offset, generator=gen, device="cuda")
        t = (t.abs_() if positive else t).mul_(scale).to(dtype)
        return t[offset:].view(shape)

    return (view(p_dtype, 1.0), view(g_dtype, 1e-2), view(p_dtype, 1e-3),
            view(p_dtype, 1e-5, positive=True))


def adam_bias(torch, precision, step):
    return precision._bias_corrections(
        torch.full((), step, dtype=torch.int32, device="cuda"),
        ADAM_HYPER[1], ADAM_HYPER[2])


def adam_edge_cases(torch, adam, precision):
    """Phase 23 (a): both variants at bf16 and f32 against the plain
    version bit for bit over 3 successive counts, at a length that is not
    a multiple of the 8-element vector and on a view one element off the
    16-byte alignment (the scalar path)."""
    n, out = 1_000_003, []
    for label, variant, pd, gd in ADAM_VARIANTS:
        for offset in (0, 1):
            p, g, mu, nu = adam_leaf_inputs(
                torch, (n,), getattr(torch, pd), getattr(torch, gd),
                len(out), offset)
            runs = {k: [t.clone() for t in (p, mu, nu)]
                    for k in ("kernel", "plain")}
            casts = {k: torch.empty(n, dtype=g.dtype, device="cuda")
                     for k in runs} if variant == "master" else None
            for step in (1, 2, 3):
                bc1, bc2 = adam_bias(torch, precision, step)
                for k, fn in (("kernel", adam._adam_cuda),
                              ("plain", adam._adam_plain)):
                    tp, tmu, tnu = runs[k]
                    fn(tp, g, tmu, tnu, *ADAM_HYPER, bc1, bc2, None,
                       None if casts is None else casts[k])
                torch.cuda.synchronize()
                got = runs["kernel"] + ([casts["kernel"]] if casts else [])
                want = runs["plain"] + ([casts["plain"]] if casts else [])
                check(all(torch.equal(a.view(torch.uint8),
                                      b.view(torch.uint8))
                          for a, b in zip(got, want)),
                      f"phase 23 (a) {label} n={n} offset {offset} step "
                      f"{step}: the kernel's bits differ from the plain "
                      "version's")
            out.append(f"{label} +{offset}")
    log(f"  (a) both variants bit-identical to the plain version over 3 "
        f"steps at n={n} (not a multiple of 8), aligned and 1 element "
        f"off: {out}")
    return out


def flagship_adam_leaves(torch, llama, cfg, variant, g_dtype):
    """The flagship's param leaves as one apply's inputs: the bf16 params
    (``adam``) or their f32 master (``master``), gradients in
    ``g_dtype``, moments in the params' dtype (f32 for the master), and
    for the master the compute cast's buffers."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    params = tree_leaves(llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    if variant == "master":
        params = [p.float() for p in params]
    gen = torch.Generator(device="cuda").manual_seed(1)

    def like(p, dtype, scale, positive=False):
        t = torch.empty(p.shape, dtype=dtype, device="cuda")
        for row in t.view(-1).split(1 << 26):      # bounded f32 draws
            r = torch.randn(row.shape, generator=gen, device="cuda")
            row.copy_((r.abs_() if positive else r).mul_(scale))
        return t

    g = [like(p, g_dtype, 1e-2) for p in params]
    mu = [like(p, p.dtype, 1e-3) for p in params]
    nu = [like(p, p.dtype, 1e-5, positive=True) for p in params]
    casts = [torch.empty(p.shape, dtype=g_dtype, device="cuda")
             for p in params] if variant == "master" else None
    return params, g, mu, nu, casts


def adam_flagship(torch, adam, precision, llama, cfg, variant, g_dtype,
                  card):
    """Phase 23 (b): one apply over the flagship's leaves, kernel against
    the plain version bit for bit leaf by leaf, then ms per apply of the
    kernel, the plain version and ``torch._fused_adam_`` (the library
    column; for the master variant over the f32 master with f32
    gradients, without the cast), beside the bytes' bound."""
    p, g, mu, nu, casts = flagship_adam_leaves(torch, llama, cfg, variant,
                                               g_dtype)
    bc1, bc2 = adam_bias(torch, precision, 1)
    worst = 0.0
    for i in range(len(p)):
        runs = {k: [t.clone() for t in (p[i], mu[i], nu[i])]
                for k in ("kernel", "plain")}
        cast = {k: None if casts is None else torch.empty_like(casts[i])
                for k in runs}
        adam._adam_cuda(*runs["kernel"][:1], g[i], *runs["kernel"][1:],
                        *ADAM_HYPER, bc1, bc2, None, cast["kernel"])
        adam._adam_plain(*runs["plain"][:1], g[i], *runs["plain"][1:],
                         *ADAM_HYPER, bc1, bc2, None, cast["plain"])
        torch.cuda.synchronize()
        got = runs["kernel"] + ([cast["kernel"]] if casts else [])
        want = runs["plain"] + ([cast["plain"]] if casts else [])
        for a, b in zip(got, want):
            worst = max(worst, float((a.float() - b.float()).abs().max()))
            check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
                  f"phase 23 (b) {variant} leaf {i} {tuple(a.shape)}: the "
                  "kernel's bits differ from the plain version's")
        del runs, cast
    torch.cuda.empty_cache()

    def apply(fn):
        def run():
            for i in range(len(p)):
                fn(p[i], g[i], mu[i], nu[i], *ADAM_HYPER, bc1, bc2, None,
                   None if casts is None else casts[i])
        return run

    n = sum(t.numel() for t in p)
    moved = nbytes(*p, *g, *mu, *nu) + nbytes(*p, *mu, *nu) + (
        nbytes(*casts) if casts else 0)
    bound_ms, bound_by = bound(moved, ADAM_FLOPS * n, "float32")
    ms = median_ms(torch, apply(adam._adam_cuda), reps=10)
    plain_ms = median_ms(torch, apply(adam._adam_plain), reps=3, warmup=1)
    lib_g = g if casts is None else [t.float() for t in g]
    steps = [torch.ones((), dtype=torch.float32, device="cuda")
             for _ in p]
    lr, b1, b2, eps = ADAM_HYPER
    library_ms = median_ms(torch, lambda: torch._fused_adam_(
        p, lib_g, mu, nu, [], steps, lr=lr, beta1=b1, beta2=b2,
        weight_decay=0.0, eps=eps, amsgrad=False, maximize=False), reps=10)
    row = dict(variant=variant, leaves=len(p), params=n,
               dtypes=f"{str(p[0].dtype)[6:]} p/mu/nu, "
                      f"{str(g_dtype)[6:]} g", bytes=moved,
               max_abs_err=worst, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               library_note="torch._fused_adam_ on the same leaves" + (
                   "" if casts is None else
                   ", the gradients upcast to f32 first (it takes no "
                   "bf16 gradient beside an f32 param) and no cast "
                   "written"))
    log(f"  (b) {variant} over the flagship's {len(p)} leaves ({n / 1e9:.3f}"
        f" B params, {row['dtypes']}): bit-identical to the plain version; "
        f"kernel {ms:.3f} ms per apply, bound {bound_ms:.3f} ms ({bound_by}, "
        f"{moved / 1e9:.2f} GB at 3.35 TB/s), plain {plain_ms:.2f} ms, "
        f"torch._fused_adam_ {library_ms:.3f} ms; card {card}")
    del p, g, mu, nu, casts, lib_g
    torch.cuda.empty_cache()
    return row


def run_adam_phase(torch, adam, precision, llama, cfg, card):
    """Phase 23: the Adam kernel against its plain version, then timed."""
    edge = adam_edge_cases(torch, adam, precision)
    torch.cuda.empty_cache()
    rows = {"adam": adam_flagship(torch, adam, precision, llama, cfg,
                                  "adam", torch.bfloat16, card),
            "master": adam_flagship(torch, adam, precision, llama, cfg,
                                    "master", torch.bfloat16, card)}
    return dict(edge_cases=edge, **rows)


# ---- phase 24: ResNet-50 on one card ----------------------------------------


def load_example(name):
    """``examples/torch_port/<name>.py`` of this checkout as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch_port", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resnet_parity(torch, resnet):
    """Phase 24 (b): depth 18, width 8, f32 (TF32 off), 4 x 32 x 32 images
    ("SAME" uneven): the loss, every gradient and the new running
    statistics on the card against the CPU on the same weights (every
    leaf perturbed from its init, so no residual branch is zero)."""
    from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map

    cfg = resnet.ResNetConfig(depth=18, num_classes=10, width=8,
                              compute_dtype="float32")
    params, state = resnet.resnet_init(cfg, torch.Generator().manual_seed(1),
                                       device="cpu")
    gen = torch.Generator().manual_seed(2)
    params = tree_map(lambda t: t + 0.1 * torch.randn(
        t.shape, generator=gen), params)
    rng = np.random.default_rng(3)
    batch = {"images": torch.from_numpy(rng.standard_normal(
                 (4, 32, 32, 3)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 10, 4))}

    def run(device):
        p = tree_map(lambda t: t.to(device).requires_grad_(True), params)
        s = tree_map(lambda t: t.to(device), state)
        b = {k: v.to(device) for k, v in batch.items()}
        loss, new_s = resnet.resnet_loss(p, s, b, cfg, device=device)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        return float(loss.detach()), [t.detach().cpu() for t in (
            *grads, *tree_leaves(new_s))]

    cpu_loss, cpu_out = run("cpu")
    card_loss, card_out = run("cuda")
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    leaf_err = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                   for a, b in zip(card_out, cpu_out))
    log(f"  (b) f32 parity, depth 18 width 8, B4 32x32: card vs CPU loss rel "
        f"err {loss_err:.3e} (tol 1e-5), gradients and running statistics "
        f"{leaf_err:.3e} (tol 2e-4 of each leaf's max abs)")
    check(loss_err <= 1e-5, f"ResNet loss on the card differs from the "
          f"CPU's by {loss_err}")
    check(leaf_err <= 2e-4, f"ResNet gradients or statistics on the card "
          f"differ from the CPU's by {leaf_err}")
    return dict(loss_rel_err=loss_err, leaf_rel_err=leaf_err)


def run_resnet_phase(torch, ctr, card, batch=128, side=224, warmup=2,
                     steps=10):
    """Phase 24: ResNet-50 trained by ``examples/torch_port/
    torch_resnet50.py``'s step (the lane open at world size 1 on NCCL)
    at B128 x 224 x 224 x 3, bf16 compute, then the f32 parity case."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.parallel._tree import tree_leaves

    example = load_example("torch_resnet50")
    cfg = resnet.ResNetConfig(depth=50, num_classes=1000)
    dev = torch.device("cuda")
    hvd.init()
    try:
        params, state = resnet.resnet_init(
            cfg, torch.Generator(device="cuda").manual_seed(0), device=dev)
        n_params = sum(t.numel() for t in tree_leaves(params))
        step = example.make_train_step(cfg, params, 0.0125 * hvd.size(),
                                       dev)
        data = example.synthetic_batch(np.random.RandomState(0), batch,
                                       side, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs = [], []
        t0 = time.perf_counter()
        for _ in range(warmup):
            loss, state = step(state, data)
            losses.append(loss)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        reset_counts(ctr)
        for _ in range(steps):
            t0 = time.perf_counter()
            loss, state = step(state, data)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(loss)
        launched = counts(ctr)
        peak = torch.cuda.max_memory_allocated()
        prof = device_profile(torch, f"ResNet-50 train step B{batch} "
                              f"{side}x{side}", lambda: step(state, data),
                              top=10)
        responses = lane_responses(hvd)
    finally:
        hvd.shutdown()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"ResNet-50: non-finite loss {losses}")
    check(not any(launched.values()),
          f"ResNet-50 launched a kernel of the port: {launched}")
    ms = float(np.median(secs)) * 1e3
    out = dict(depth=50, batch=batch, image=side, n_params=n_params,
               dtype=cfg.compute_dtype, ms_per_step=ms,
               step_ms=[x * 1e3 for x in secs],
               images_per_s=batch / (ms / 1e3), peak_gib=peak / 2**30,
               first_steps_s=first_s, losses=losses,
               busy_share=None if prof is None else 1 - prof["idle_share"],
               profile=prof, lane_responses=responses)
    log(f"  (a) ResNet-50 ({n_params / 1e6:.2f} M params, f32 params, bf16 "
        f"compute, NHWC) B{batch} x {side}x{side}, torch_resnet50.py's step "
        f"(SGD momentum 0.9, gradients averaged on the lane, NCCL, world "
        f"size 1): {ms:.1f} ms/step (median of {steps}; "
        f"{[round(x * 1e3, 1) for x in secs]}), {out['images_per_s']:.1f} "
        f"images/s, peak {out['peak_gib']:.2f} GiB, first {warmup} steps "
        f"{first_s:.2f} s, device busy share "
        f"{'not measured' if prof is None else round(out['busy_share'], 3)}"
        f"; losses {[round(x, 4) for x in losses]}; card {card}")
    out["parity"] = resnet_parity(torch, resnet)
    return out


# ---- phase 25: the mesh path's blocks and Mixtral-8x7B -------------------


def mixtral_config(LlamaConfig, layers=2):
    """Mixtral-8x7B (``LlamaConfig.mixtral_8x7b``: vocab 32000, d4096,
    H32/Hkv8, d_ff 14336, 8 experts top-2) at full width cut to
    ``layers`` layers, the GShard dispatch, bf16 compute and storage,
    ``remat="attn+gate"`` (which saves the dispatch and combine)."""
    return dataclasses.replace(LlamaConfig.mixtral_8x7b(), n_layers=layers,
                               dtype="bfloat16", param_dtype="bfloat16",
                               remat="attn+gate", moe_impl="gshard")


def gshard_against_grouped(torch, ctr, llama, train_step, params, cfg, data):
    """At capacity_factor = E/K (C = T: nothing can drop) one grad call
    through the GShard dispatch and one through the grouped K5/K6 path on
    the same params and batch: the losses (bf16, 1e-2 relative) and each
    gradient leaf (norm-relative, 5e-2), the grouped call's launches."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    c = dataclasses.replace(cfg, remat="none", capacity_factor=float(
        cfg.n_experts // cfg.n_experts_per_token))
    out, launched = {}, None
    for impl in ("gshard", "grouped"):
        ci = dataclasses.replace(c, moe_impl=impl)
        reset_counts(ctr)
        loss, grads = train_step._value_and_grad(
            lambda p, d: llama.llama_loss(p, d, ci), params, data, 1)
        torch.cuda.synchronize()
        if impl == "grouped":
            launched = counts(ctr)
            check_wgmma_routes(ctr, "Mixtral grouped grad call")
        out[impl] = (float(loss), tree_leaves(grads))
        del grads
    (g_loss, g_grads), (k_loss, k_grads) = out["gshard"], out["grouped"]
    loss_rel = abs(g_loss - k_loss) / abs(k_loss)
    grad_rel = max(norm_rel(a, b) for a, b in zip(g_grads, k_grads))
    L = cfg.n_layers
    want = {"K1": L, "K2": L, "K3": L, "K5": 3 * L, "K6 dlhs": 3 * L,
            "K6 tgmm": 3 * L}
    log(f"  GShard (capacity_factor {c.capacity_factor}, C = T) against "
        f"the grouped K5/K6 path, one grad call each: loss {g_loss:.6f} / "
        f"{k_loss:.6f} (relative {loss_rel:.3e}, tol 1e-2), largest "
        f"gradient leaf norm-relative difference {grad_rel:.3e} (tol 5e-2); "
        f"grouped launches {launched}")
    check(loss_rel <= 1e-2, f"GShard loss {g_loss} against grouped {k_loss}")
    check(grad_rel <= 5e-2, f"GShard gradients against grouped: {grad_rel}")
    for k, n in want.items():
        check(launched[k] == n, f"the grouped grad call launched {k} "
              f"{launched[k]} times, expected {n}")
    return launched, dict(capacity_factor=c.capacity_factor,
                          gshard_loss=g_loss, grouped_loss=k_loss,
                          loss_rel=loss_rel, grad_norm_rel_max=grad_rel)


def run_mixtral_train(torch, ctr, llama, precision, train_step, cfg, batch,
                      seq, steps, card):
    """Phase 25 (a): Mixtral-8x7B at full width, 2 layers, without a
    mesh, the GShard dispatch: split steps with ``fused_adam(3e-4)``,
    then GShard against the grouped path where nothing can drop."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    params = llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    total, active = param_counts(params, cfg)
    log(f"  Mixtral-8x7B, {cfg.n_layers} of 32 layers: {total / 1e9:.3f} B "
        f"params, {active / 1e9:.3f} B active, {total * 2 / 1e9:.2f} GB "
        f"bf16 ({total * 8 / 1e9:.2f} GB with gradients and Adam moments)")
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        batch, seq)).astype(np.int32)).cuda()
    data = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    ts = train_step.make_split_train_step(
        lambda p, d: llama.llama_loss(p, d, cfg), precision.fused_adam(3e-4))
    carry = ts.init(params)
    del params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, carry = ts.step(carry, data)                      # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reset_counts(ctr)
    secs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, carry = ts.step(carry, data)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
    launched = counts(ctr)
    check_wgmma_routes(ctr, "Mixtral train step")
    check_adam(ctr, "Mixtral train step", len(tree_leaves(carry[0])), steps)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    L = cfg.n_layers
    per_call = {"K1": L, "K2": L, "K3": L, "K4": 0, "K5": 0, "K6 dlhs": 0,
                "K6 tgmm": 0}
    for k, n in per_call.items():
        check(launched[k] == n * steps,
              f"Mixtral: {k} launched {launched[k]} times in {steps} steps, "
              f"expected {n} per grad call")
    check(all(np.isfinite(losses)), f"Mixtral: non-finite loss {losses}")
    ms = float(np.median(secs)) * 1e3
    tok = batch * seq
    flops_per_token = 6 * active + 12 * L * seq * cfg.d_model
    mfu = flops_per_token * tok / (ms / 1e3) / PEAK_FLOPS["bfloat16"]
    log(f"  (a) Mixtral train step B{batch} T{seq} remat={cfg.remat} GShard "
        f"(capacity_factor {cfg.capacity_factor}) bf16 fused_adam: {ms:.1f} "
        f"ms/step (median of {steps}; {[round(x * 1e3, 1) for x in secs]}), "
        f"{tok / (ms / 1e3):.0f} tok/s, active-parameter MFU {mfu:.4f}, peak "
        f"memory {peak / 2**30:.2f} GiB, first step {first_s:.2f} s; losses "
        f"{[round(x, 4) for x in losses]}; launches {launched} (per grad "
        f"call: {per_call}); card {card}")
    prof = device_profile(torch, f"Mixtral train step B{batch} T{seq}",
                          lambda: ts.step(carry, data), top=10)
    grouped_launch, parity = gshard_against_grouped(
        torch, ctr, llama, train_step, carry[0], cfg, data)
    return launched, grouped_launch, dict(
        n_layers=L, ms_per_step=ms, step_ms=[x * 1e3 for x in secs],
        tok_s=tok / (ms / 1e3), mfu=mfu, peak_mem_gib=peak / 2**30,
        first_step_s=first_s, losses=losses, n_params=total,
        n_active_params=active, profile=prof, against_grouped=parity)


def tensor_blocks(torch, rules, layer, t, rank):
    """Tensor rank ``rank``'s blocks of a one-layer tree under a
    ``tensor=t`` mesh: ``shard_params`` with the model's partition
    ``rules``, as a mesh rank takes them (a ``Mesh`` of the shape alone:
    no groups)."""
    from horovod_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh
    from horovod_tpu_torch.parallel.sharding import shard_params

    shape = {a: (t if a == "tensor" else 1) for a in AXIS_ORDER}
    mesh = Mesh(shape, rank, torch.device("cuda"), {}, None)
    blocks, _ = shard_params({"layers": layer}, mesh, rules)
    return {k: v[0] for k, v in blocks["layers"].items()}


def run_tensor_replay(torch, ctr, llama, cfg, card, t=4, batch=2, seq=2048):
    """Phase 25 (b): one flagship layer's attention and MLP blocks as the
    ``tensor=t`` mesh runs them (``_attention_block``, ``_dense_ffn``),
    each shard's blocks with a ``None`` group (so each returns its
    partial sum), forward and backward on the card; the ``t`` partial
    outputs and input gradients summed against the unsharded blocks."""
    one = dataclasses.replace(cfg, n_layers=1)
    layer = llama.llama_init(one, torch.Generator(device="cuda").manual_seed(
        4), device="cuda")["layers"]
    full = {k: v[0] for k, v in layer.items()}
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((batch, seq, cfg.d_model), generator=g,
                    device="cuda").to(cfg.compute_dtype)
    probe = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
    positions = torch.arange(seq, device="cuda").expand(batch, seq)

    def blocks(lp, xi):
        xi = xi.detach().requires_grad_(True)
        attn = llama._attention_block(xi, lp, cfg, positions)
        ffn = llama._dense_ffn(xi, lp, cfg)
        dx, = torch.autograd.grad(((attn + ffn) * probe).float().sum(), xi)
        return attn.detach(), ffn.detach(), dx

    shards = [tensor_blocks(torch, llama.llama_partition_rules(), layer, t, i)
              for i in range(t)]
    heads = shards[0]["wq"].shape[1] // cfg.head_dim, \
        shards[0]["wk"].shape[1] // cfg.head_dim
    reset_counts(ctr)
    parts = [blocks(lp, x) for lp in shards]
    torch.cuda.synchronize()
    launched = counts(ctr)
    check_wgmma_routes(ctr, f"tensor={t} replay")
    for k in ("K1", "K2", "K3"):
        check(launched[k] == t, f"tensor={t} replay: {k} launched "
              f"{launched[k]} times, expected {t} (one a shard)")
    want = blocks(full, x)
    got = [sum(p[i].float() for p in parts) for i in range(3)]
    errs = {name: norm_rel(a, w) for name, a, w in
            zip(("attention", "mlp", "dx"), got, want)}
    shard_ms = cuda_ms(torch, lambda: llama._attention_block(
        x, shards[0], cfg, positions), 10)
    full_ms = cuda_ms(torch, lambda: llama._attention_block(
        x, full, cfg, positions), 10)
    log(f"  (b) tensor={t} replay of one flagship layer (H{cfg.n_heads}/"
        f"Hkv{cfg.n_kv_heads} -> {heads[0]}/{heads[1]} heads a shard), "
        f"B{batch} T{seq}: the {t} partial sums against the unsharded "
        f"blocks, norm-relative {errs} (tol 2e-2); launches {launched}; "
        f"a shard's attention forward {shard_ms:.3f} ms, the unsharded "
        f"{full_ms:.3f} ms; card {card}")
    for name, e in errs.items():
        check(e <= 2e-2, f"tensor={t} replay: {name} off by {e}")
    return launched, dict(tensor=t, heads_a_shard=heads, norm_rel=errs,
                          shard_attention_ms=shard_ms,
                          full_attention_ms=full_ms)


def run_mesh_phase(torch, ctr, llama, precision, train_step, LlamaConfig,
                   card):
    """Phase 25: (a) Mixtral-8x7B, (b) the tensor=4 replay."""
    mixtral_launch, grouped_launch, mixtral = run_mixtral_train(
        torch, ctr, llama, precision, train_step,
        mixtral_config(LlamaConfig), 2, 2048, 3, card)
    torch.cuda.empty_cache()
    replay_launch, replay = run_tensor_replay(
        torch, ctr, llama, flagship_config(LlamaConfig), card)
    torch.cuda.empty_cache()
    return ({"mixtral_train_step": mixtral_launch,
             "mixtral_grouped_grad": grouped_launch,
             "tensor4_replay": replay_launch},
            dict(mixtral=mixtral, tensor_replay=replay))


# ---- phase 26: BERT-Large and the grouped dispatch as tensor shards --------


def run_bert_tensor_replay(torch, ctr, bert, card, t=4, batch=16, seq=512):
    """Phase 26 (a): one BERT-Large layer's attention and MLP blocks as
    the ``tensor=t`` mesh runs them (``bert._attention_block``,
    ``_mlp_block``: K1-K3's bias variant on H/t heads), each shard with a
    ``None`` group so each returns its partial sum; forward and backward
    on the card, the ``t`` partial outputs and input gradients summed
    against the unsharded blocks, with the same seeded padding bias."""
    cfg = bert.BertConfig.large()
    layer = bert.bert_init(dataclasses.replace(cfg, n_layers=1),
                           torch.Generator(device="cuda").manual_seed(4),
                           device="cuda")["layers"]
    full = {k: v[0] for k, v in layer.items()}
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((batch, seq, cfg.d_model), generator=g,
                    device="cuda").to(cfg.compute_dtype)
    probe = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
    kv_bias = padding_bias(torch, padding_lengths(torch, batch, seq, 31), seq)

    def blocks(lp, xi):
        xi = xi.detach().requires_grad_(True)
        attn = bert._attention_block(xi, lp, kv_bias, cfg)
        mlp = bert._mlp_block(xi, lp, cfg)
        dx, = torch.autograd.grad(((attn + mlp) * probe).float().sum(), xi)
        return attn.detach(), mlp.detach(), dx

    shards = [tensor_blocks(torch, bert.bert_partition_rules(), layer, t, i)
              for i in range(t)]
    heads = shards[0]["wq"].shape[1] // cfg.head_dim
    reset_counts(ctr)
    parts = [blocks(lp, x) for lp in shards]
    torch.cuda.synchronize()
    launched, biased = counts(ctr), bias_counts(ctr)
    check_wgmma_routes(ctr, f"BERT tensor={t} replay")
    for k in ("K1", "K2", "K3"):
        check(launched[k] == t and biased[k] == t,
              f"BERT tensor={t} replay: {k} launched {launched[k]} times "
              f"({biased[k]} biased), expected {t} biased (one a shard)")
    want = blocks(full, x)
    got = [sum(p[i].float() for p in parts) for i in range(3)]
    errs = {name: norm_rel(a, w) for name, a, w in
            zip(("attention", "mlp", "dx"), got, want)}
    shard_ms = cuda_ms(torch, lambda: bert._attention_block(
        x, shards[0], kv_bias, cfg), 10)
    full_ms = cuda_ms(torch, lambda: bert._attention_block(
        x, full, kv_bias, cfg), 10)
    log(f"  (a) BERT-Large tensor={t} replay of one layer (H{cfg.n_heads} "
        f"-> {heads} heads a shard, D{cfg.head_dim}), B{batch} T{seq}, "
        f"seeded padding: the {t} partial sums against the unsharded "
        f"blocks, norm-relative {errs} (tol 2e-2); launches {launched}, "
        f"biased {biased}; a shard's attention forward {shard_ms:.3f} ms, "
        f"the unsharded {full_ms:.3f} ms; card {card}")
    for name, e in errs.items():
        check(e <= 2e-2, f"BERT tensor={t} replay: {name} off by {e}")
    return launched, dict(tensor=t, heads_a_shard=heads, norm_rel=errs,
                          bias_launches=biased, shard_attention_ms=shard_ms,
                          full_attention_ms=full_ms)


def run_grouped_tensor_replay(torch, ctr, llama, gm, LlamaConfig, card, t=4,
                              batch=2, seq=2048):
    """Phase 26 (b): one Mixtral layer's dropless grouped expert FFN
    (``grouped_moe_ffn``) as the ``tensor=t`` mesh runs it: each shard's
    experts at F/t columns (gate/up) and rows (down), K5 forward and K6
    backward, with a ``None`` group so each returns its partial output;
    the ``t`` partial outputs and input gradients summed, and the
    shards' weight gradients joined, against the unsharded layer."""
    cfg = dataclasses.replace(mixtral_config(LlamaConfig, layers=1),
                              moe_impl="grouped", remat="none")
    layer = llama.llama_init(cfg, torch.Generator(device="cuda").manual_seed(
        5), device="cuda")["layers"]
    keys = ("router", "moe_gate", "moe_up", "moe_down")
    layer = {k: layer[k] for k in keys}
    full = {k: v[0] for k, v in layer.items()}
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((batch, seq, cfg.d_model), generator=g,
                    device="cuda").to(cfg.compute_dtype)
    probe = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)

    def ffn(lp, xi):
        xi = xi.detach().requires_grad_(True)
        w = [lp[k].detach().requires_grad_(True) for k in keys[1:]]
        y, _ = gm.grouped_moe_ffn(xi, {"router": lp["router"],
                                       **dict(zip(keys[1:], w))}, cfg)
        grads = torch.autograd.grad((y * probe).float().sum(), [xi, *w])
        return y.detach(), *grads

    shards = [tensor_blocks(torch, llama.llama_partition_rules(), layer, t, i)
              for i in range(t)]
    f_shard = shards[0]["moe_gate"].shape[-1]
    reset_counts(ctr)
    parts = [ffn(lp, x) for lp in shards]
    torch.cuda.synchronize()
    launched = counts(ctr)
    check_wgmma_routes(ctr, f"grouped tensor={t} replay")
    for k in ("K5", "K6 dlhs", "K6 tgmm"):
        check(launched[k] == 3 * t, f"grouped tensor={t} replay: {k} "
              f"launched {launched[k]} times, expected {3 * t} (3 a shard)")
    want = ffn(full, x)
    got = [sum(p[0].float() for p in parts), sum(p[1].float() for p in parts),
           torch.cat([p[2] for p in parts], -1),
           torch.cat([p[3] for p in parts], -1),
           torch.cat([p[4] for p in parts], -2)]
    names = ("y", "dx", "d moe_gate", "d moe_up", "d moe_down")
    errs = {n: norm_rel(a, w) for n, a, w in zip(names, got, want)}
    log(f"  (b) Mixtral grouped expert FFN as tensor={t} shards (F "
        f"{cfg.d_ff} -> {f_shard} a shard, 8 experts top-2), B{batch} "
        f"T{seq}: partial outputs, input gradients and joined weight "
        f"gradients against the unsharded layer, norm-relative {errs} "
        f"(tol 2e-2); launches {launched}; card {card}")
    for n, e in errs.items():
        check(e <= 2e-2, f"grouped tensor={t} replay: {n} off by {e}")
    return launched, dict(tensor=t, f_a_shard=f_shard, norm_rel=errs)


def run_shard_phase(torch, ctr, bert, llama, gm, LlamaConfig, card):
    """Phase 26: (a) BERT-Large's layer, (b) Mixtral's grouped FFN, each
    as tensor=4 shards."""
    bert_launch, bert_replay = run_bert_tensor_replay(torch, ctr, bert, card)
    torch.cuda.empty_cache()
    grouped_launch, grouped_replay = run_grouped_tensor_replay(
        torch, ctr, llama, gm, LlamaConfig, card)
    torch.cuda.empty_cache()
    return ({"bert_tensor4_replay": bert_launch,
             "grouped_tensor4_replay": grouped_launch},
            dict(bert=bert_replay, grouped=grouped_replay))


# ---- phase 27: the disaggregated serving loop and ZeRO's re-layout ------

SERVE_FLAG = "--serve-worker"
SERVE_KILL_ROUND = 6
SERVE_TIMEOUT_S = 420
# Phase 4's engine shape: 16 requests of 17-128 prompt tokens, 32 new.
SERVE_LOOP = dict(block_size=32, n_blocks=128, max_batch=16,
                  max_context=160, steps_per_round=4, prefill_per_round=4)


def serving_trace(poisson_trace, cfg, n=16, rps=50.0, seed=1):
    """Phase 4's load on a Poisson clock: ``n`` requests at ``rps``, prompts
    of 17-128 tokens, 32 new tokens each."""
    return poisson_trace(n, rps, seed=seed, prompt_len=(17, 128),
                         max_new=(32, 32), vocab_size=cfg.vocab_size)


def serving_cfg(LlamaConfig, mode):
    """The served model of a mode: the flagship in bf16, or its widths at
    2 layers in f32 (the token-parity drill)."""
    cfg = flagship_config(LlamaConfig)
    if mode == "f32":
        cfg = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                                  param_dtype="float32")
    return cfg


def run_loop_one(torch, ctr, ServingLoop, poisson_trace, params, cfg):
    """(a) ``ServingLoop`` at world size 1 (no lane: the frontend decodes
    too), int8 KV: every request completes, K1 once a layer a prefill.
    K4 never launches: the continuous-batching step attends through
    ``decode_attention_ragged``, the plain chain in both packages (the
    JAX package's ``horovod_tpu/ops/decode_attention.py:106`` is an
    einsum chain, no Pallas kernel); K4 is ``llama_generate``'s."""
    trace = serving_trace(poisson_trace, cfg)
    warm = ServingLoop(params, cfg, trace[:2], quantized=True,
                       device="cuda", **SERVE_LOOP)
    warm.run()
    torch.cuda.synchronize()
    reset_counts(ctr)
    loop = ServingLoop(params, cfg, trace, quantized=True, device="cuda",
                       **SERVE_LOOP)
    t0 = time.perf_counter()
    rep = loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts(ctr)
    check_wgmma_routes(ctr, "ServingLoop")
    sched = loop.engine.scheduler
    L, n = cfg.n_layers, len(trace)
    check(rep["served"] == n, f"served {rep['served']} of {n}")
    prefills = n + sched.evictions
    check(launched["K1"] == L * prefills,
          f"K1 launched {launched['K1']} times, expected {L} a prefill x "
          f"{prefills}")
    check(launched["K4"] == 0 and loop.engine.steps > 0,
          f"K4 launched {launched['K4']} times in {loop.engine.steps} "
          "decode steps of the ragged (plain) attention, expected none")
    for r in trace:
        toks = rep["completed"][r.rid]
        check(len(toks) == len(r.prompt) + r.max_new_tokens and
              ((toks >= 0) & (toks < cfg.vocab_size)).all(),
              f"request {r.rid}: bad tokens")
    stats = dict(wall_s=wall, tok_s=rep["sustained_tok_s"],
                 p50_ms=rep["p50_ms"], p99_ms=rep["p99_ms"],
                 steps=loop.engine.steps, rounds=rep["rounds"],
                 evictions=sched.evictions, prefills=prefills)
    log(f"  ServingLoop (size 1) {n} requests, int8 KV: {wall:.3f} s, "
        f"{rep['sustained_tok_s']} tok/s, p50 {rep['p50_ms']} ms, p99 "
        f"{rep['p99_ms']} ms, {loop.engine.steps} decode steps, "
        f"{rep['rounds']} rounds; launches {launched}")
    small = serving_trace(poisson_trace, cfg, n=4)
    stats["profile"] = device_profile(
        torch, "ServingLoop 4 requests x 32 new",
        lambda: ServingLoop(params, cfg, small, quantized=True,
                            device="cuda", **SERVE_LOOP).run())
    return launched, stats, rep["completed"]


def serve_worker(mode, out):
    """A rank of phase 27 (b)'s drill (``chip_smoke.py --serve-worker
    f32|bf16 OUT``): the lane on gloo (two ranks cannot share a card on
    NCCL), the engine on ``cuda:0``, rank 1 SIGKILLed at round
    ``SERVE_KILL_ROUND``; rank 0 writes ``OUT/rank0.json``."""
    import signal

    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.models import generate as gen
    from horovod_tpu_torch.models.llama import LlamaConfig, llama_init
    from horovod_tpu_torch.ops import adam
    from horovod_tpu_torch.ops import decode_attention as da
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import grouped_moe as gm
    from horovod_tpu_torch.serving.scheduler import poisson_trace
    from horovod_tpu_torch.serving.service import ServingLoop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The two ranks share the host: half its cores each for the pool's
    # host-side operations (torch's default is every core per process).
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    ctr = launch_counters(fa, da, gm, adam)
    hvd.init(device="cpu")
    cfg = serving_cfg(LlamaConfig, mode)
    params = llama_init(cfg, torch.Generator(device="cuda").manual_seed(
        0 if mode == "bf16" else 1), device="cuda")
    trace = serving_trace(poisson_trace, cfg)

    beats = []

    def hook(loop, round_idx):
        if hvd.rank() == 1 and round_idx == SERVE_KILL_ROUND:
            os.kill(os.getpid(), signal.SIGKILL)
        beats.append((round_idx, time.perf_counter(), hvd.size()))

    # A warm-up trace first, as a service warms up before it takes
    # traffic: a fresh process's first prefill and decode steps pay
    # 10-14 s of one-time costs on the card.
    ServingLoop(params, cfg, trace[:3], quantized=mode == "bf16",
                device="cuda:0", **SERVE_LOOP).run()
    reset_counts(ctr)
    loop = ServingLoop(params, cfg, trace, quantized=mode == "bf16",
                       round_hook=hook, device="cuda:0", **SERVE_LOOP)
    rep = loop.run()
    torch.cuda.synchronize()
    record = dict(
        completed={int(k): v.tolist() for k, v in rep["completed"].items()},
        requeued=sorted(loop.requeued_rids), launches=counts(ctr),
        **{k: rep[k] for k in ("served", "faults_survived", "rounds",
                               "sustained_tok_s", "p50_ms", "p99_ms",
                               "wall_s", "evictions")},
        latency_ms={int(k): v * 1e3 for k, v in rep["latency_s"].items()},
        recoveries=rep["recoveries"], size=hvd.size(),
        rounds_s=[(r, round(t - beats[0][1], 3), n) for r, t, n in beats])
    if mode == "f32":
        record["generate"] = {
            r.rid: gen.llama_generate(params, r.prompt[None, :], cfg,
                                      r.max_new_tokens,
                                      device="cuda")[0].cpu().tolist()
            for r in trace}
    hvd.shutdown()
    with open(os.path.join(out, "rank0.json"), "w") as f:
        json.dump(record, f)


def run_serve_drill(mode, out):
    """Two ``serve_worker`` processes on this card; returns rank 0's
    record and the victim's exit code."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for rank in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), SERVE_FLAG, mode,
             out], env=env))
    try:
        rc0 = procs[0].wait(timeout=SERVE_TIMEOUT_S)
        rc1 = procs[1].wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(rc0 == 0, f"phase 27 (b) {mode}: rank 0 exited {rc0}")
    check(rc1 == -9, f"phase 27 (b) {mode}: the victim exited {rc1}, not "
          "by SIGKILL (the chaos never fired)")
    with open(os.path.join(out, "rank0.json")) as f:
        return json.load(f)


def top2_margin(torch, llama, params, cfg, tokens):
    """The top-2 logit margin of the bf16 forward at the last position of
    ``tokens``."""
    with torch.no_grad():
        logits = llama.llama_forward(
            params, torch.tensor([tokens], dtype=torch.int32,
                                 device="cuda"), cfg,
            device="cuda")[0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def run_two_rank_drills(torch, llama, params, cfg, one_card, n_req):
    """(b) the two-rank drill at f32 (2 layers: tokens against
    ``llama_generate``) and at the flagship in bf16 with int8 KV (tokens
    against (a)'s, each difference with its top-2 logit margin)."""
    import tempfile

    out = {}
    for mode in ("f32", "bf16"):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            rec = run_serve_drill(mode, d)
            rec["drill_s"] = time.perf_counter() - t0
        check(rec["served"] == n_req and rec["faults_survived"] >= 1 and
              rec["size"] == 1 and rec["requeued"],
              f"phase 27 (b) {mode}: served {rec['served']}, faults "
              f"{rec['faults_survived']}, size {rec['size']}, requeued "
              f"{rec['requeued']}")
        if mode == "f32":
            bad = [rid for rid, toks in rec["completed"].items()
                   if toks != rec["generate"][str(rid)]]
            check(not bad, f"phase 27 (b) f32: requests {bad} differ from "
                  "llama_generate")
        else:
            diffs = {}
            for rid, toks in rec["completed"].items():
                want = one_card[int(rid)].tolist()
                if toks != want:
                    i = next(j for j, (a, b) in enumerate(zip(toks, want))
                             if a != b)
                    diffs[int(rid)] = dict(
                        at=i, margin=top2_margin(torch, llama, params, cfg,
                                                 want[:i]))
            rec["equal_to_one_rank"] = n_req - len(diffs)
            rec["differences"] = diffs
        rec.pop("generate", None)
        lat = rec.pop("latency_ms")
        log(f"  2 ranks on one card ({mode}, rank 1 killed at round "
            f"{SERVE_KILL_ROUND}): {rec['served']}/{n_req} served, re-queued "
            f"{rec['requeued']}, {rec['sustained_tok_s']} tok/s, p50 "
            f"{rec['p50_ms']} ms, p99 {rec['p99_ms']} ms, drill "
            f"{rec['drill_s']:.1f} s; rank 0 launches {rec['launches']}; "
            f"rounds (round, s, size) {rec.pop('rounds_s')}; recoveries "
            f"(round, s) {rec['recoveries']}"
            + (f"; equal to (a): {rec['equal_to_one_rank']}/{n_req}, "
               f"differences {rec['differences']}" if mode == "bf16"
               else "; tokens == llama_generate"))
        rec["latency_ms_max"] = max(lat.values())
        rec.pop("completed")
        out[mode] = rec
    return out


def run_zero_relayout(torch, layout_leaves):
    """(c) the 4 -> 3 hand-over of the flagship's ZeRO carry (``fused_adam``:
    bf16 mu and nu, one block a rank of each bucket) replayed on one card:
    each survivor's block joined from the segments the plan's alltoallv
    sends it (``reshard.alltoallv_splits``, the splits ``execute_plan``
    uses), bit for bit against ``simulate_plan``, timed beside the HBM
    bound of reading and writing every row once."""
    from horovod_tpu_torch.parallel import reshard as R
    from horovod_tpu_torch.parallel import zero as Z

    old, victims = 4, {3}
    alive = [r for r in range(old) if r not in victims]
    m = len(alive)
    layout = Z.zero_bucket_layout(layout_leaves, old, Z.DEFAULT_BUCKET_BYTES)
    g = torch.Generator(device="cuda").manual_seed(27)
    plans, blocks = [], []
    for b in layout.buckets:
        s, n = b.padded // old, b.nelems
        s_new = max(-(-n // m) * m, m) // m
        src = [max(0, min(n, (r + 1) * s) - r * s) for r in range(old)]
        dst = [0 if r in victims else
               max(0, min(n, (alive.index(r) + 1) * s_new)
                   - alive.index(r) * s_new) for r in range(old)]
        plan = R.plan_redistribute((n,), np.dtype("V2"), R.rows_layout(src),
                                   R.rows_layout(dst))
        splits = [R.alltoallv_splits(plan, 0, r, src[r]) for r in range(old)]
        for field in range(2):
            full = torch.randn(b.padded, generator=g, device="cuda",
                               dtype=torch.float32).to(b.dtype)
            full[n:] = 0
            blocks.append((plan, splits, src, dst, s_new,
                           [full[r * s:r * s + src[r]] for r in range(old)]))

    def relayout():
        out = []
        for plan, splits, src, dst, s_new, bl in blocks:
            pieces = [torch.split(bl[r], splits[r]) for r in range(old)]
            out.append([torch.cat([pieces[r][d] for r in range(old)] +
                                  [bl[0].new_zeros(s_new - dst[d])])
                        for d in alive])
        return out

    ms = cuda_ms(torch, relayout, 3, warmup=1)
    got = relayout()
    torch.cuda.synchronize()
    total = moved = 0
    for (plan, splits, src, dst, s_new, bl), new in zip(blocks, got):
        want = R.simulate_plan(plan, [b.view(torch.int16).cpu().numpy()
                                      for b in bl])
        for d, blk in zip(alive, new):
            check(blk.numel() == s_new and not blk[dst[d]:].any() and
                  np.array_equal(blk[:dst[d]].view(torch.int16).cpu()
                                 .numpy(), want[d]),
                  "phase 27 (c): a survivor's block differs from "
                  "simulate_plan")
        total += sum(src) * 2
        moved += plan.wire_tx_bytes()
    bound_ms = 2 * total / HBM_BYTES_PER_S * 1e3
    log(f"  4 -> 3 ZeRO re-layout on one card: {len(layout.buckets)} "
        f"buckets x mu, nu ({total / 1e9:.3f} GB of bf16 moments): "
        f"{ms:.3f} ms beside the HBM bound {bound_ms:.3f} ms (each row "
        f"read and written once); the plans' alltoallv sends "
        f"{moved / 1e9:.3f} GB between cards; bit-exact against "
        "simulate_plan")
    return dict(buckets=len(layout.buckets), state_bytes=total, ms=ms,
                bound_ms=bound_ms, wire_bytes=moved)


def run_serving_loop_phase(torch, ctr, llama, LlamaConfig, llama_init,
                           poisson_trace, card):
    from horovod_tpu_torch.parallel._tree import tree_leaves
    from horovod_tpu_torch.parallel.zero import LeafSpec
    from horovod_tpu_torch.serving.service import ServingLoop

    cfg = flagship_config(LlamaConfig)
    params = llama_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    log("  (a) one rank")
    launched, one, completed = run_loop_one(torch, ctr, ServingLoop,
                                            poisson_trace, params, cfg)
    log("  (b) two ranks on one card, a gloo lane")
    drills = run_two_rank_drills(torch, llama, params, cfg, completed,
                                 len(completed))
    leaves = [LeafSpec(tuple(w.shape), w.dtype) for w in tree_leaves(params)]
    del params
    torch.cuda.empty_cache()
    log("  (c) ZeRO's 4 -> 3 re-layout replayed on one card")
    relayout = run_zero_relayout(torch, leaves)
    torch.cuda.empty_cache()
    return launched, dict(one_rank=one, two_ranks=drills, relayout=relayout,
                          card=card)


# ---- phase 28: the pipeline schedules and the last three remat modes -------


def llama3_8b_config(LlamaConfig, layers=8):
    """Llama-3-8B (``LlamaConfig.llama3_8b``: vocab 128256, d4096,
    H32/Hkv8, d_ff 14336) at full width cut to ``layers`` layers, bf16
    compute and storage, ``remat="attn+gate"``."""
    return dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=layers,
                               dtype="bfloat16", param_dtype="bfloat16",
                               remat="attn+gate")


def pipelined_counts(schedule, L, M, per):
    """A pipelined grad call's launches, derived from the schedule:
    ``per`` is a gpipe grad call's launches a (layer, microbatch) (its
    forward once, its backward, what the remat mode re-runs); a fused
    schedule's backward subtick re-runs each layer's forward once more
    (K1, and the MoE's three K5). Nothing runs in a bubble slot."""
    extra = {} if schedule == "gpipe" else {"K1": 1, "K5": 3 if per.get(
        "K5") else 0}
    return {k: (n + extra.get(k, 0)) * L * M for k, n in per.items()}


def timed_step(torch, ts, carry, data, steps):
    """One warm-up and ``steps`` split steps: (ms a step, the median,
    peak GiB of the timed steps)."""
    loss, carry = ts.step(carry, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, carry = ts.step(carry, data)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(loss)), f"non-finite loss {float(loss)}")
    return (float(np.median(secs)) * 1e3,
            torch.cuda.max_memory_allocated() / 2**30)


def grad_call(torch, ctr, llama, train_step, params, cfg, data, **kw):
    """One grad call of ``llama_loss``: (loss, gradient leaves, launches,
    peak GiB); every routed launch on wgmma."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    reset_counts(ctr)
    torch.cuda.reset_peak_memory_stats()
    loss, grads = train_step._value_and_grad(
        lambda p, d: llama.llama_loss(p, d, cfg, **kw), params, data, 1)
    torch.cuda.synchronize()
    check_wgmma_routes(ctr, f"grad call {cfg.pipeline_schedule} "
                            f"remat={cfg.remat}")
    return (float(loss), tree_leaves(grads), counts(ctr),
            torch.cuda.max_memory_allocated() / 2**30)


def run_pipeline_replays(torch, ctr, llama, pipeline, precision, train_step,
                         cfg, card, S=4, M=8, seq=2048, steps=2):
    """Phase 28 (a): gpipe, 1f1b and interleaved_1f1b (V=2) replayed on
    one card through the in-process transport, ``S`` stages, ``M``
    microbatches of one row: each schedule's loss and gradient leaves
    against the unpipelined ``llama_loss`` on the same batch (bf16: loss
    1e-2 relative, each leaf 5e-2 norm-relative, phase 25's envelope),
    K1-K3 as the schedule predicts, on wgmma; ms a split step
    (``fused_adam(3e-4)``) beside the unpipelined step's."""
    from horovod_tpu_torch.parallel._tree import tree_map

    params = llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(28)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        M, seq)).astype(np.int32)).cuda()
    data = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    L = cfg.n_layers
    ref_loss, ref_grads, ref_launch, ref_peak = grad_call(
        torch, ctr, llama, train_step, params, cfg, data)
    check(ref_launch["K1"] == L, f"unpipelined K1 {ref_launch['K1']}")
    schedules = (("gpipe", "gpipe", 1), ("1f1b", "1f1b", 1),
                 ("interleaved_1f1b V=2", "interleaved_1f1b", 2))
    launched, rows = {}, {}
    for name, sched, v in schedules:
        c = dataclasses.replace(cfg, pipeline_schedule=sched,
                                pipeline_virtual_stages=v,
                                pipeline_microbatches=M)
        loss, grads, n, peak = grad_call(
            torch, ctr, llama, train_step, params, c, data,
            transport=pipeline.InProcessTransport(S))
        want = pipelined_counts(sched, L, M, {"K1": 1, "K2": 1, "K3": 1})
        for k, w in want.items():
            check(n[k] == w, f"{name}: {k} launched {n[k]} times, the "
                  f"schedule predicts {w}")
        check(n["K5"] == 0, f"{name}: the dense model launched K5")
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        grad_rel = max(norm_rel(a, b) for a, b in zip(grads, ref_grads))
        del grads
        check(loss_rel <= 1e-2, f"{name}: loss {loss} against {ref_loss}")
        check(grad_rel <= 5e-2, f"{name}: gradients off by {grad_rel}")
        launched[name] = n
        rows[name] = dict(loss=loss, loss_rel=loss_rel,
                          grad_norm_rel_max=grad_rel, launches=want,
                          grad_call_peak_gib=peak)
    del ref_grads
    torch.cuda.empty_cache()
    for name, sched, v in (("unpipelined", "gpipe", 1),) + schedules:
        c = dataclasses.replace(cfg, pipeline_schedule=sched,
                                pipeline_virtual_stages=v,
                                pipeline_microbatches=M)
        kw = {} if name == "unpipelined" else dict(
            transport=pipeline.InProcessTransport(S))
        ts = train_step.make_split_train_step(
            lambda p, d, c=c, kw=kw: llama.llama_loss(p, d, c, **kw),
            precision.fused_adam(3e-4))
        ms, peak = timed_step(torch, ts, ts.init(tree_map(
            lambda w: w.clone(), params)), data, steps)
        rows.setdefault(name, {}).update(ms_per_step=ms, peak_gib=peak)
        del ts
        torch.cuda.empty_cache()
    sched = pipeline.build_interleaved_schedule(S, 2, M)
    log(f"  (a) Llama-3-8B {L} of 32 layers (d{cfg.d_model}, H{cfg.n_heads}/"
        f"Hkv{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"remat={cfg.remat}, bf16, B{M} x T{seq} as {M} microbatches over "
        f"{S} stages in one process (unpipelined loss {ref_loss:.5f}, "
        f"{ref_launch['K1']} K1 a grad call; interleaved V=2: "
        f"{sched.n_slots} slots, bubble {sched.bubble_fraction:.4f}); card "
        f"{card}")
    for name, r in rows.items():
        log(f"    {name}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items()) + f"; card {card}")
    del params
    torch.cuda.empty_cache()
    return ({f"pipeline {name}": n for name, n in launched.items()},
            dict(stages=S, microbatches=M, seq=seq, layers=L,
                 unpipelined_loss=ref_loss, schedules=rows, card=card))


def run_moe_pipeline(torch, ctr, llama, pipeline, train_step, cfg, card,
                     S=2, M=4, seq=2048):
    """Phase 28 (b): ``benchmarks/moe_bench.py``'s MoE (grouped K5/K6,
    ``remat="moe"``) under ``1f1b`` and gpipe, ``S`` stages, ``M``
    microbatches of one row, in one process, each against its exact
    unpipelined counterpart: the mean over m of the unpipelined
    ``llama_loss`` on microbatch m (the aux loss is taken a microbatch;
    equal rows and no mask make the token mean the same), in the bf16
    envelope (loss 1e-2 relative, each leaf 5e-2 norm-relative); K5/K6
    and K1-K3 as the schedule predicts."""
    params = llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    rng = np.random.default_rng(29)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        M, seq)).astype(np.int32)).cuda()
    data = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    L = cfg.n_layers
    t0 = time.perf_counter()
    ref_loss, ref_grads = 0.0, None
    for m in range(M):
        loss, grads, *_ = grad_call(torch, ctr, llama, train_step, params,
                                    cfg, {k: v[m:m + 1]
                                          for k, v in data.items()})
        ref_loss += loss / M
        if ref_grads is None:
            ref_grads = [g.float() / M for g in grads]
        else:
            for acc, g in zip(ref_grads, grads):
                acc.add_(g.float() / M)
        del grads
    plain_ms = (time.perf_counter() - t0) * 1e3
    out, launched, rows = {}, {}, {}
    for sched in ("gpipe", "1f1b"):
        c = dataclasses.replace(cfg, pipeline_schedule=sched,
                                pipeline_microbatches=M)
        t0 = time.perf_counter()
        loss, grads, launched[sched], _ = grad_call(
            torch, ctr, llama, train_step, params, c, data,
            transport=pipeline.InProcessTransport(S))
        ms = (time.perf_counter() - t0) * 1e3
        rows[sched] = dict(
            loss=loss, loss_rel=abs(loss - ref_loss) / abs(ref_loss),
            grad_norm_rel_max=max(norm_rel(a, b)
                                  for a, b in zip(grads, ref_grads)),
            first_grad_call_ms=ms)
        out[sched] = grads
    # remat="moe" saves the grouped chain: per (layer, microbatch) the
    # forward's 3 K5, the dlhs and tgmm halves 3 each in the backward.
    per = {"K1": 1, "K2": 1, "K3": 1, "K5": 3, "K6 dlhs": 3, "K6 tgmm": 3}
    for sched in ("gpipe", "1f1b"):
        want = pipelined_counts(sched, L, M, per)
        got = {k: launched[sched][k] for k in want}
        check(got == want, f"MoE {sched}: launches {got}, the schedule "
              f"predicts {want}")
    between = max(norm_rel(a, b) for a, b in zip(out["1f1b"], out["gpipe"]))
    log(f"  (b) MoE (moe_bench's config, L{L}, 4 experts top-2, grouped, "
        f"remat={cfg.remat}) B{M} x T{seq} as {M} microbatches over {S} "
        f"stages, against the mean of {M} unpipelined grad calls, one a "
        f"microbatch (loss {ref_loss:.5f}; {plain_ms:.1f} ms for the {M}, "
        f"first calls): " + "; ".join(
            f"{s} loss {r['loss']:.5f} (relative {r['loss_rel']:.3e}, tol "
            f"1e-2), largest leaf norm-relative {r['grad_norm_rel_max']:.3e}"
            f" (tol 5e-2), first grad call {r['first_grad_call_ms']:.1f} ms"
            for s, r in rows.items())
        + f"; 1f1b against gpipe {between:.3e}; launches 1f1b "
        f"{launched['1f1b']}, gpipe {launched['gpipe']}; card {card}")
    for sched, r in rows.items():
        check(r["loss_rel"] <= 1e-2, f"MoE {sched} loss {r['loss']} against "
              f"{ref_loss}")
        check(r["grad_norm_rel_max"] <= 5e-2, f"MoE {sched} gradients off "
              f"by {r['grad_norm_rel_max']}")
    del params, out, ref_grads
    torch.cuda.empty_cache()
    return ({f"pipeline MoE {s}": launched[s] for s in ("gpipe", "1f1b")},
            dict(stages=S, microbatches=M, reference_loss=ref_loss,
                 schedules=rows, one_f_one_b_vs_gpipe=between, card=card))


def run_remat_modes(torch, ctr, llama, precision, train_step, cfg, card,
                    batch=4, seq=2048, steps=3):
    """Phase 28 (c): the flagship's split step at B4 x T2048 under
    ``dots``, ``attn+ffn`` and ``attn+gate+qkv`` beside ``attn+gate``:
    K1/K5 a grad call (``dots`` re-runs K1), ms a step and peak GiB, and
    the gradients equal to ``attn+gate``'s (a recompute re-runs the same
    kernels on the same inputs: bit for bit expected, else the largest
    difference printed and the phase failed)."""
    from horovod_tpu_torch.parallel._tree import tree_map

    params = llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        batch, seq)).astype(np.int32)).cuda()
    data = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    L = cfg.n_layers
    base, rows, launched = None, {}, {}
    for mode, k1 in (("attn+gate", L), ("dots", 2 * L), ("attn+ffn", L),
                     ("attn+gate+qkv", L)):
        c = dataclasses.replace(cfg, remat=mode)
        loss, grads, n, grad_peak = grad_call(torch, ctr, llama, train_step,
                                              params, c, data)
        check(n["K1"] == k1 and n["K2"] == n["K3"] == L and n["K5"] == 0,
              f"remat={mode}: launches {n}, expected K1 {k1}, K2 = K3 = {L}")
        launched[mode] = n
        if base is None:
            base = (loss, grads)
            same, diff = True, 0.0
        else:
            same = loss == base[0] and all(
                torch.equal(a, b) for a, b in zip(grads, base[1]))
            diff = max(norm_rel(a, b) for a, b in zip(grads, base[1]))
            del grads
            check(same, f"remat={mode}: loss {loss} and gradients not "
                  f"bit-identical to attn+gate's (largest leaf {diff:.3e} "
                  f"norm-relative, loss {base[0]})")
        ts = train_step.make_split_train_step(
            lambda p, d, c=c: llama.llama_loss(p, d, c),
            precision.fused_adam(3e-4))
        ms, peak = timed_step(torch, ts, ts.init(tree_map(
            lambda w: w.clone(), params)), data, steps)
        del ts
        torch.cuda.empty_cache()
        rows[mode] = dict(K1=n["K1"], K5=n["K5"], ms_per_step=ms,
                          peak_gib=peak, grad_call_peak_gib=grad_peak,
                          bitwise_equal=same, grad_norm_rel_max=diff)
        log(f"  (c) flagship B{batch} T{seq} remat={mode}: K1 {n['K1']} K5 "
            f"{n['K5']} a grad call, {ms:.1f} ms/step (median of {steps}), "
            f"peak {peak:.2f} GiB (grad call {grad_peak:.2f}), gradients "
            f"{'bit-identical to' if same else f'{diff:.3e} off'} attn+gate's;"
            f" card {card}")
    del params, base
    torch.cuda.empty_cache()
    return ({f"remat {m}": n for m, n in launched.items() if m != "attn+gate"},
            rows)


def run_pipeline_phase(torch, ctr, llama, pipeline, precision, train_step,
                       LlamaConfig, card):
    """Phase 28: (a) the schedules at Llama-3-8B's width, (b) the MoE
    under 1f1b, (c) the remat modes dots, attn+ffn and attn+gate+qkv on
    the flagship."""
    t0 = time.perf_counter()
    paths, replays = run_pipeline_replays(
        torch, ctr, llama, pipeline, precision, train_step,
        llama3_8b_config(LlamaConfig), card)
    moe_paths, moe = run_moe_pipeline(torch, ctr, llama, pipeline,
                                      train_step, moe_config(LlamaConfig),
                                      card)
    remat_paths, remat = run_remat_modes(torch, ctr, llama, precision,
                                         train_step,
                                         flagship_config(LlamaConfig), card)
    secs = time.perf_counter() - t0
    log(f"  phase 28: {secs:.1f} s")
    return {**paths, **moe_paths, **remat_paths}, dict(
        replays=replays, moe=moe, remat=remat, seconds=secs)


# ---- phase 29: checkpoints in flight, the loader, master_weights ------------


def seeded_loader(torch, data_mod, cfg, batch, seq, steps, start=0):
    """A port ``AsyncDataLoaderMixin`` loader of ``steps`` seeded batches
    on the card, from batch ``start``: batch i is the same in every
    loader, whichever thread made it."""

    class Batches(data_mod.BaseDataLoader):
        def __len__(self):
            return steps - start

        def _iterate(self):
            for i in range(start, steps):
                rng = np.random.default_rng(100 + i)
                tokens = torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (batch, seq)).astype(np.int32))
                tokens = tokens.pin_memory().to("cuda", non_blocking=True)
                yield {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}

    class AsyncBatches(data_mod.AsyncDataLoaderMixin, Batches):
        pass

    return AsyncBatches(async_depth=2)


def checkpoint_round_trip(torch, ctr, ckpt, ts, params, loader_at, tmp,
                          label, card, steps=2):
    """Train ``steps`` steps, save the carry with an async
    ``CheckpointManager`` (max_to_keep=1), train ``steps`` more at once
    (the in-place apply runs while the write is in flight), wait, restore
    into a fresh carry and run the same ``steps`` steps: the losses and
    every leaf bit-identical to the uninterrupted run. Returns the
    numbers and the uninterrupted steps' ms."""
    from horovod_tpu_torch.parallel._tree import tree_map

    def leaves(x):
        if torch.is_tensor(x):
            return [x]
        if isinstance(x, dict):
            return [t for k in sorted(x) for t in leaves(x[k])]
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in leaves(v)]
        return []

    carry = ts.init(tree_map(lambda w: w.clone(), params))
    it = iter(loader_at(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        loss, carry = ts.step(carry, next(it))
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    mgr = ckpt.CheckpointManager(tmp, max_to_keep=1, async_save=True)
    t0 = time.perf_counter()
    check(mgr.save(steps, carry), f"{label}: the save was skipped")
    save_ms = (time.perf_counter() - t0) * 1e3
    losses, step_ms = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        loss, carry = ts.step(carry, next(it))
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t1) * 1e3)
    in_flight = mgr._thread is not None and mgr._thread.is_alive()
    t1 = time.perf_counter()
    mgr.wait()
    wait_s = time.perf_counter() - t1
    flush_s, nbytes = mgr.last_write_s, mgr.last_write_bytes
    want = leaves(carry)
    fresh = ts.init(tree_map(lambda w: torch.zeros_like(w), params))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    restored = mgr.restore(target=fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    del fresh
    check(all(t.device.type == "cuda" for t in leaves(restored)),
          f"{label}: a restored leaf is not on the card")
    it = iter(loader_at(steps))
    again = []
    for _ in range(steps):
        loss, restored = ts.step(restored, next(it))
        again.append(float(loss))
    got = leaves(restored)
    same = again == losses and len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    check(same, f"{label}: the resumed steps' losses {again} and leaves "
          f"are not bit-identical to the uninterrupted run's {losses}")
    # A second save of the same manager: the first one's pinned buffers
    # take its snapshot; retention keeps the newest step only.
    t1 = time.perf_counter()
    check(mgr.save(2 * steps, restored), f"{label}: the second save was "
          "skipped")
    save2_ms = (time.perf_counter() - t1) * 1e3
    mgr.wait()
    check(mgr.all_steps() == [2 * steps], f"{label}: max_to_keep=1 left "
          f"steps {mgr.all_steps()}")
    log(f"  {label}: save call {save_ms:.1f} ms (blocking; the write in "
        f"flight through the next step: {in_flight}), flush {flush_s:.2f} s "
        f"for {nbytes / 1e9:.3f} GB ({nbytes / flush_s / 1e9:.2f} GB/s), "
        f"wait {wait_s:.2f} s, restore {restore_s:.2f} s; resumed losses "
        f"{again} bit-identical, {len(got)} leaves bit-identical; step "
        f"{min(step_ms):.1f} ms; a second save {save2_ms:.1f} ms (pinned "
        f"buffers reused), flush {mgr.last_write_s:.2f} s; card {card}")
    del carry, restored, want, got
    torch.cuda.empty_cache()
    return dict(save_ms=save_ms, flush_s=flush_s, bytes=nbytes,
                wait_s=wait_s, restore_s=restore_s, in_flight=in_flight,
                losses=losses, bitwise_equal=same, step_ms=step_ms,
                save2_ms=save2_ms, flush2_s=mgr.last_write_s,
                peak_gib=peak_gib)


def run_master_weights(torch, ctr, llama, precision, params, cfg, loader_at,
                       steps=3):
    """``master_weights(torch.optim.Adam)`` for ``steps`` steps: the loss
    backward on ``compute_params``, then ``apply``. ms a step (the last
    ``steps - 1``) and peak GiB."""
    from horovod_tpu_torch.parallel._tree import (
        tree_leaves,
        tree_map,
        tree_unflatten,
    )

    mw = precision.master_weights(lambda ps: torch.optim.Adam(ps, lr=3e-4))
    state = mw.init(params)
    check(all(m.dtype == torch.float32 for m in tree_leaves(state.master)),
          "master_weights: the master is not f32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    it = iter(loader_at(0))
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        live = tree_map(lambda p: p.requires_grad_(True),
                        mw.compute_params(state))
        loss = llama.llama_loss(live, next(it), cfg)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        state = mw.apply(state, tree_unflatten(live, list(grads)))
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    moments = [v for s in state.inner.state.values() for k, v in s.items()
               if k in ("exp_avg", "exp_avg_sq")]
    check(moments and all(m.dtype == torch.float32 for m in moments),
          "master_weights: Adam's moments are not f32")
    check(all(np.isfinite(losses)), f"master_weights: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, moments
    torch.cuda.empty_cache()
    return dict(losses=losses, ms_per_step=float(np.median(ms[1:])),
                peak_gib=peak)


def run_checkpoint_phase(torch, ctr, llama, precision, train_step,
                         LlamaConfig, card, batch=4, seq=2048, steps=2):
    """Phase 29: (a) the dense flagship's split step (``fused_adam``),
    its batches through an ``AsyncDataLoaderMixin`` loader, checkpointed
    in flight and resumed bit-identically; (b) the same round trip of
    ``fused_master_adam``'s carry at the flagship's width with 2 layers,
    then ``master_weights(torch.optim.Adam)`` on that model beside the
    fused split step's ms and peak."""
    import shutil
    import tempfile

    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import data as data_mod
    from horovod_tpu_torch.parallel._tree import tree_leaves

    t_phase = time.perf_counter()
    d2h, h2d = copy_rates(torch)
    tmp = tempfile.mkdtemp(prefix="hvd_ckpt_")
    try:
        cfg = flagship_config(LlamaConfig)
        params = llama.llama_init(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        n_leaves = len(tree_leaves(params))
        ts = train_step.make_split_train_step(
            lambda p, d: llama.llama_loss(p, d, cfg),
            precision.fused_adam(3e-4))
        loader_at = lambda start: seeded_loader(  # noqa: E731
            torch, data_mod, cfg, batch, seq, 2 * steps, start)
        free = shutil.disk_usage(tmp).free
        log(f"  {free / 1e9:.1f} GB free under {tmp}; pinned copy rates "
            f"D2H {d2h / 1e9:.2f} GB/s, H2D {h2d / 1e9:.2f} GB/s")
        reset_counts(ctr)
        a = checkpoint_round_trip(
            torch, ctr, ckpt, ts, params, loader_at,
            os.path.join(tmp, "flagship"),
            f"(a) flagship B{batch} T{seq} fused_adam", card, steps)
        a_launch = counts(ctr)
        check_wgmma_routes(ctr, "checkpointed train step")
        runs = 3 * steps
        L = cfg.n_layers
        for k in ("K1", "K2", "K3"):
            check(a_launch[k] == L * runs,
                  f"(a): {k} launched {a_launch[k]} times in {runs} steps, "
                  f"expected {L} a step")
        check_adam(ctr, "(a) checkpointed train step", n_leaves, runs)
        a["bound_save_ms"] = a["bytes"] / d2h * 1e3
        a["bound_restore_ms"] = a["bytes"] / h2d * 1e3
        log(f"  (a) the save call {a['save_ms']:.1f} ms against the "
            f"pinned D2H bound {a['bound_save_ms']:.1f} ms of its "
            f"{a['bytes'] / 1e9:.3f} GB; the restore {a['restore_s']:.2f} s "
            f"against the H2D bound {a['bound_restore_ms'] / 1e3:.2f} s; "
            f"launches {a_launch} ({L} K1-K3 a step, {n_leaves} Adam)")
        del params, ts
        torch.cuda.empty_cache()

        # f32 params for the f32 master; the compute stays bf16.
        cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32")
        params = llama.llama_init(
            cfg2, torch.Generator(device="cuda").manual_seed(1),
            device="cuda")
        ts = train_step.make_split_train_step(
            lambda p, d: llama.llama_loss(p, d, cfg2),
            precision.fused_master_adam(3e-4))
        loader_at = lambda start: seeded_loader(  # noqa: E731
            torch, data_mod, cfg2, batch, seq, 2 * steps, start)
        reset_counts(ctr)
        b = checkpoint_round_trip(
            torch, ctr, ckpt, ts, params, loader_at,
            os.path.join(tmp, "master"),
            "(b) flagship width, 2 layers, fused_master_adam", card, steps)
        b_launch = counts(ctr)
        check_wgmma_routes(ctr, "checkpointed master step")
        check_adam(ctr, "(b) checkpointed master step", len(tree_leaves(
            params)), 3 * steps, variant="master")
        del ts
        torch.cuda.empty_cache()
        reset_counts(ctr)
        mw = run_master_weights(torch, ctr, llama, precision, params, cfg2,
                                loader_at)
        mw_launch = counts(ctr)
        for k in ("K1", "K2", "K3"):
            check(mw_launch[k] == cfg2.n_layers * 3,
                  f"master_weights: {k} launched {mw_launch[k]} times in 3 "
                  f"steps, expected {cfg2.n_layers} a step")
        check(mw_launch["Adam"] == 0, "master_weights launched the port's "
              "Adam kernel: its optimizer is torch.optim.Adam")
        log(f"  (b) master_weights(torch.optim.Adam): {mw['ms_per_step']:.1f}"
            f" ms/step (median of the last 2 of 3), peak {mw['peak_gib']:.2f}"
            f" GiB, losses {[round(x, 4) for x in mw['losses']]}; "
            f"fused_master_adam's split step {min(b['step_ms']):.1f} ms, "
            f"peak {b['peak_gib']:.2f} GiB (its first steps, the params "
            f"held as here); card {card}")
        del params
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), f"phase 29 left {tmp} behind")
    secs = time.perf_counter() - t_phase
    log(f"  phase 29: {secs:.1f} s")
    b_launch = {**b_launch, "Adam master": b_launch["Adam"], "Adam": 0}
    paths = {"checkpointed_train_step": a_launch,
             "checkpointed_master_step": b_launch,
             "master_weights_step": mw_launch}
    return paths, dict(flagship=a, master=b, master_weights=mw,
                       d2h_bytes_s=d2h, h2d_bytes_s=h2d, seconds=secs)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "needs an NVIDIA card")
    try:
        from horovod_tpu_torch.models import bert
        from horovod_tpu_torch.models import generate as gen
        from horovod_tpu_torch.models import llama
        from horovod_tpu_torch.models.llama import LlamaConfig, llama_init
        from horovod_tpu_torch.ops import _build, adam
        from horovod_tpu_torch.ops import decode_attention as da
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import grouped_moe as gm
        from horovod_tpu_torch.parallel import (
            pipeline,
            precision,
            train_step,
        )
        from horovod_tpu_torch.parallel.ring_attention import (
            ring_flash_steps,
        )
        from horovod_tpu_torch.serving.engine import DecodeEngine
        from horovod_tpu_torch.serving.scheduler import (
            Request,
            poisson_trace,
        )
    except ImportError as e:
        raise SmokeFailure(f"horovod_tpu_torch not importable ({e}): run "
                           "from the root of a repo checkout") from e
    # Full-f32 products everywhere: the parity phases compare f32 paths
    # token for token and gradient for gradient.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctr = launch_counters(fa, da, gm, adam)
    t_start = time.perf_counter()

    log("phase 1: card and build")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"  card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, capability {cap}, "
        f"{torch.cuda.device_count()} device(s)")
    check(cap >= (9, 0), f"needs compute capability >= 9.0, got {cap}")
    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(build_logs) or 'all cached'})")
    for name, text in build_logs.items():
        for line in ptxas_summary(text):
            log(f"    {name}: {line}")
    attrs = wgmma_attrs(_build)

    log("phase 2: kernels against their plain versions")
    bf16, f32 = torch.bfloat16, torch.float32
    # Phase 25's shapes last: Mixtral's attention (H32 Hkv8) and a
    # tensor=4 shard of the flagship's (4 heads, 1 kv head).
    k1 = [flash_case(torch, fa, 16, 128, bf16, 50, attrs),
          flash_case(torch, fa, 1, 77, bf16, 50, attrs),
          flash_case(torch, fa, 1, 4096, bf16, 20, attrs),
          flash_case(torch, fa, 4, 2048, bf16, 20, attrs),
          flash_case(torch, fa, 2, 2048, bf16, 20, attrs, hkv=8),
          flash_case(torch, fa, 4, 128, f32, 20, attrs),
          flash_case(torch, fa, 2, 2048, bf16, 20, attrs, h=32, hkv=8),
          flash_case(torch, fa, 2, 2048, bf16, 20, attrs, h=4, hkv=1)]
    bwd = [bwd_case(torch, fa, 4, 2048, bf16, 5, attrs),
           bwd_case(torch, fa, 2, 2048, bf16, 5, attrs, hkv=8),
           bwd_case(torch, fa, 1, 77, bf16, 20, attrs),
           bwd_case(torch, fa, 2, 256, f32, 10, attrs),
           bwd_case(torch, fa, 2, 2048, bf16, 5, attrs, h=32, hkv=8),
           bwd_case(torch, fa, 2, 2048, bf16, 5, attrs, h=4, hkv=1)]
    k2, k3 = [c[0] for c in bwd], [c[1] for c in bwd]
    # K4 at both generate paths' decode steps (dense Hkv4 n_rep4, MoE
    # Hkv8 n_rep2; S192), a long cache, and f32 (the FMA route).
    k4 = [decode_case(torch, da, 16, 4, 4, 192, 150, bf16, 100, attrs,
                      one_launch=True),
          decode_case(torch, da, 16, 8, 2, 192, 150, bf16, 100, attrs,
                      one_launch=True),
          decode_case(torch, da, 1, 4, 4, 32768, 32767, bf16, 50, attrs),
          decode_case(torch, da, 16, 4, 4, 192, 150, f32, 50, attrs)]
    # K5/K6 at the MoE paths' shapes: one train microbatch routes 8192
    # rows (B2 T2048, top-2), a b16 x 128 prefill 4096, a b16 decode step
    # 32 (gate/up and down: the shapes K5 splits along K); then f32 (the
    # parity phase's B2 T256) and a skewed routing with an empty group and
    # boundaries off the 128-row tile.
    train_sizes = [2100, 1900, 2300, 1892]
    gmm_cases = [
        gmm_case(torch, gm, "train gate/up", train_sizes, 2048, 4096, bf16,
                 20, attrs),
        gmm_case(torch, gm, "train down", train_sizes, 4096, 2048, bf16, 20,
                 attrs),
        gmm_case(torch, gm, "prefill gate/up", [1000, 1100, 980, 1016],
                 2048, 4096, bf16, 5, attrs, backward=False),
        gmm_case(torch, gm, "prefill down", [1000, 1100, 980, 1016],
                 4096, 2048, bf16, 5, attrs, backward=False),
        gmm_case(torch, gm, "decode gate/up", [9, 7, 10, 6], 2048, 4096,
                 bf16, 20, attrs, backward=False),
        gmm_case(torch, gm, "decode down", [9, 7, 10, 6], 4096, 2048,
                 bf16, 20, attrs, backward=False),
        gmm_case(torch, gm, "f32 gate/up", [300, 250, 222, 252], 2048, 4096,
                 f32, 3, attrs),
        gmm_case(torch, gm, "skewed gate/up", [0, 5000, 3001, 191], 2048,
                 4096, bf16, 20, attrs),
    ]
    # Mixtral's experts (d4096, F 14336, 8 experts) as the tensor=2 and
    # tensor=4 shards of the grouped dispatch under a mesh run them:
    # B2 T2048 top-2 routes 8192 rows; gate/up at F/t columns, down at F/t
    # rows (phase 26 (b) and the four-card Mixtral case).
    shard_sizes = [1100, 950, 1020, 1080, 990, 1010, 1040, 1002]
    for t in (2, 4):
        gmm_cases += [
            gmm_case(torch, gm, f"Mixtral tensor={t} gate/up", shard_sizes,
                     4096, 14336 // t, bf16, 10, attrs),
            gmm_case(torch, gm, f"Mixtral tensor={t} down", shard_sizes,
                     14336 // t, 4096, bf16, 10, attrs)]
    k5 = [c["K5"] for c in gmm_cases]
    k6 = [c[h] for c in gmm_cases for h in ("K6 dlhs", "K6 tgmm") if h in c]

    log("phase 3: llama_generate at flagship width")
    cfg = flagship_config(LlamaConfig)
    params = llama_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    n_params = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "lm_head"))
    log(f"  flagship: {n_params / 1e9:.3f} B params, "
        f"{n_params * 2 / 1e9:.2f} GB bf16")
    gen_launch, gen_stats = run_generate(torch, ctr, gen, params, cfg,
                                         16, 128, 64)

    log("phase 4: DecodeEngine at flagship width")
    eng_launch, eng_stats = run_engine(torch, ctr, DecodeEngine, Request,
                                       params, cfg)
    del params
    torch.cuda.empty_cache()

    log("phase 5: engine/generate token parity (f32, 2 layers)")
    run_parity(gen, DecodeEngine, poisson_trace, llama_init, torch, cfg)

    log("phase 6: training at flagship width")
    train_launch, train_stats = run_train(
        torch, ctr, llama, precision, train_step, cfg, 4, 2048, 5, card)
    torch.cuda.empty_cache()

    log("phase 7: training parity (f32, 2 layers) and remat modes")
    flash_counts = {"K1": 2, "K2": 2, "K3": 2}
    parity = run_train_parity(torch, ctr, llama, train_step, cfg, {
        "none": flash_counts, "full": dict(flash_counts, K1=4),
        "attn": flash_counts, "attn+gate": flash_counts,
        "dots": dict(flash_counts, K1=4), "attn+ffn": flash_counts,
        "attn+gate+qkv": flash_counts})
    torch.cuda.empty_cache()

    log("phase 8: MoE training at full width (benchmarks/moe_bench.py)")
    mcfg = moe_config(LlamaConfig)
    moe_ffn_without_host_sync(torch, gm, mcfg, 4096)
    moe_train_launch, moe_train_stats = run_moe_train(
        torch, ctr, llama, precision, train_step, mcfg, 4, 2048, 4, card)
    torch.cuda.empty_cache()

    log("phase 9: MoE serving at full width")
    params = llama_init(mcfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    moe_gen_launch, moe_gen_stats = run_moe_generate(torch, ctr, gen,
                                                     params, mcfg)
    moe_eng_launch, moe_eng_stats = run_moe_engine(
        torch, ctr, DecodeEngine, Request, params, mcfg)
    del params
    torch.cuda.empty_cache()

    log("phase 10: MoE parity (f32, 2 layers): training, remat modes, "
        "engine/generate tokens")
    # Per grad call at 2 layers: K5 3 per layer in the forward, plus what
    # each backward re-runs (3 under full/dots/attn/attn+gate/
    # attn+gate+qkv/attn+ffn, 2 under attn+moe, none under moe); K6's
    # halves 3 per layer in every mode.
    moe_counts = {"K1": 2, "K2": 2, "K3": 2, "K5": 6, "K6 dlhs": 6,
                  "K6 tgmm": 6}
    moe_parity = run_train_parity(torch, ctr, llama, train_step, mcfg, {
        "none": moe_counts, "full": dict(moe_counts, K1=4, K5=12),
        "attn": dict(moe_counts, K5=12), "attn+gate": dict(moe_counts, K5=12),
        "attn+moe": dict(moe_counts, K5=10), "moe": moe_counts,
        "dots": dict(moe_counts, K1=4, K5=12),
        "attn+ffn": dict(moe_counts, K5=12),
        "attn+gate+qkv": dict(moe_counts, K5=12)})
    run_parity(gen, DecodeEngine, poisson_trace, llama_init, torch, mcfg)
    bf16_check = run_bf16_grad_check(torch, ctr, fa, llama, train_step,
                                     mcfg)

    log("phase 11: the Horovod eager lane on NCCL (world size 1)")
    lane = run_lane(torch, llama, train_step, cfg, card)
    torch.cuda.empty_cache()

    log("phase 12: the kernels' bias variant at BERT-Large's attention")
    # B16 H16 T512 D64 non-causal (the train step's shape) with a padding
    # bias and a random one; f32 on the FMA route (B2 T128).
    # Phase 26's shapes last: a tensor=2 and a tensor=4 shard of it (H8,
    # H4).
    bias_cases = [bias_case(torch, fa, 16, 512, bf16, 20, attrs, "padding"),
                  bias_case(torch, fa, 16, 512, bf16, 20, attrs, "random"),
                  bias_case(torch, fa, 2, 128, f32, 10, attrs, "padding"),
                  bias_case(torch, fa, 16, 512, bf16, 20, attrs, "padding",
                            h=8),
                  bias_case(torch, fa, 16, 512, bf16, 20, attrs, "padding",
                            h=4)]

    log("phase 13: BERT-Large MLM training at full width and depth")
    bcfg = bert.BertConfig.large()
    bert_train_launch, bert_train_stats, bert_params, bert_data = \
        run_bert_train(torch, ctr, bert, precision, train_step, bcfg, 16,
                       512, 2, 5, card)

    log("phase 14: bert_forward at the train batch")
    bert_fwd_launch, bert_fwd_stats = run_bert_forward(
        torch, ctr, bert, bcfg, bert_params, bert_data)
    del bert_params, bert_data
    torch.cuda.empty_cache()

    log("phase 15: BERT parity (f32 and bf16, 2 layers)")
    bert_parity = run_bert_parity(torch, ctr, fa, bert, train_step, bcfg)
    torch.cuda.empty_cache()

    log("phase 16: the kernels' offsets variant at a seq=4 ring's chunks "
        "(the flagship's attention, B1 x T16384)")
    # H16 Hkv4 D128 bf16, chunks of 4096: the chunks one rank meets (past,
    # diagonal, wholly future), a chunk starting inside a q tile, Tq !=
    # Tk, a random lse cotangent; f32 on the FMA route (B2 T256).
    c = 4096
    offsets_cases = [
        offsets_case(torch, fa, "past", 1, c, c, 3 * c, 0, bf16, 10),
        offsets_case(torch, fa, "diagonal", 1, c, c, c, c, bf16, 10),
        offsets_case(torch, fa, "future", 1, c, c, 0, 3 * c, bf16, 10),
        offsets_case(torch, fa, "misaligned", 1, c, c, c + 37, c, bf16, 10),
        offsets_case(torch, fa, "Tq != Tk", 1, c, c // 2, c, c, bf16, 10),
        offsets_case(torch, fa, "dlse", 1, c, c, c, c, bf16, 10,
                     with_dlse=True),
        offsets_case(torch, fa, "f32", 2, 256, 256, 256 + 37, 256, f32, 10,
                     with_dlse=True)]

    log("phase 17: a seq=4 ring replayed on one card (B1 x T16384)")
    ring = run_ring_replay(torch, ctr, fa, ring_flash_steps)
    torch.cuda.empty_cache()

    log("phase 18: elastic training on NCCL (world size 1), BERT-Large "
        "at full width")
    elastic_launch, elastic = run_elastic(
        torch, ctr, bert, precision, train_step, bcfg, 16, 512, card,
        bert_train_stats["ms_per_step"])
    torch.cuda.empty_cache()

    log("phase 19: the lane's autotuner and the parole door on NCCL "
        "(world size 1)")
    tuning = run_lane_tuning(
        torch, ctr, llama, bert, precision, train_step, cfg, bcfg, card,
        lane["cache_on"]["grouped_allreduce_"]["bound_ms"],
        elastic["torch_state"]["reset_ms"] + elastic["tree_state"]["reset_ms"])
    torch.cuda.empty_cache()

    log("phase 20: the lane's wire codecs and the cross-plane allreduce")
    wire = run_wire(torch, llama, cfg, card)
    torch.cuda.empty_cache()

    log("phase 21: the port's launcher on the card")
    launched = run_launcher_phase(torch, bert, precision, train_step, bcfg,
                                  card, bert_train_stats["ms_per_step"])
    torch.cuda.empty_cache()

    log("phase 22: ZeRO-1 on the jit lane and the eager lane (world "
        "size 1)")
    zero_launch, zero = run_zero_phase(torch, ctr, llama, precision,
                                       train_step, cfg, card)
    torch.cuda.empty_cache()

    log("phase 23: the Adam update as one kernel (csrc/adam.cu)")
    adam_stats = run_adam_phase(torch, adam, precision, llama, cfg, card)
    torch.cuda.empty_cache()

    log("phase 24: ResNet-50 on one card (examples/torch_port/"
        "torch_resnet50.py's step)")
    resnet50 = run_resnet_phase(torch, ctr, card)
    torch.cuda.empty_cache()

    log("phase 25: Mixtral-8x7B (2 layers, GShard) and a tensor=4 replay "
        "of a flagship layer")
    mesh_paths, mesh_stats = run_mesh_phase(
        torch, ctr, llama, precision, train_step, LlamaConfig, card)

    log("phase 26: a BERT-Large layer and a Mixtral layer's grouped "
        "expert FFN as tensor=4 shards")
    shard_paths, shard_stats = run_shard_phase(
        torch, ctr, bert, llama, gm, LlamaConfig, card)

    log("phase 27: the disaggregated serving loop (one rank; two ranks on "
        "one card with a kill) and ZeRO's 4 -> 3 re-layout")
    loop_launch, loop_stats = run_serving_loop_phase(
        torch, ctr, llama, LlamaConfig, llama_init, poisson_trace, card)

    log("phase 28: the pipeline schedules replayed on one card (Llama-3-8B, "
        "8 layers; the MoE under 1f1b) and the remat modes dots, attn+ffn, "
        "attn+gate+qkv")
    pipe_paths, pipe_stats = run_pipeline_phase(
        torch, ctr, llama, pipeline, precision, train_step, LlamaConfig, card)

    log("phase 29: the flagship's split step checkpointed in flight and "
        "resumed (batches through the async loader), the master variant "
        "and master_weights(torch.optim.Adam)")
    ckpt_paths, ckpt_stats = run_checkpoint_phase(
        torch, ctr, llama, precision, train_step, LlamaConfig, card)

    log("phase 30: results")
    log(f"  the smoke's wall time to here: "
        f"{time.perf_counter() - t_start:.1f} s; card {card}")
    log(json.dumps({"generate": gen_stats, "engine": eng_stats,
                    "train": train_stats, "train_parity": parity,
                    "moe_train": moe_train_stats,
                    "moe_generate": moe_gen_stats,
                    "moe_engine": moe_eng_stats,
                    "moe_train_parity": moe_parity,
                    "moe_bf16_grad_check": bf16_check, "lane": lane,
                    "bert_train": bert_train_stats,
                    "bert_forward": bert_fwd_stats,
                    "bert_parity": bert_parity, "ring_replay": ring,
                    "elastic": elastic, "lane_tuning": tuning,
                    "wire": wire, "launcher": launched, "zero": zero,
                    "adam": adam_stats, "resnet50": resnet50,
                    "mesh": mesh_stats, "shards": shard_stats,
                    "serving_loop": loop_stats, "pipeline": pipe_stats,
                    "checkpoint": ckpt_stats, "card": card}))
    paths = {"llama_generate": gen_launch, "DecodeEngine": eng_launch,
             "train_step": train_launch, "moe_train_step": moe_train_launch,
             "moe_llama_generate": moe_gen_launch,
             "moe_DecodeEngine": moe_eng_launch,
             "bert_train_step": bert_train_launch,
             "bert_forward": bert_fwd_launch,
             "elastic_bert_train": elastic_launch,
             "zero_train_step": zero_launch, **mesh_paths, **shard_paths,
             "ServingLoop": loop_launch, **pipe_paths, **ckpt_paths}
    bert_bias = {k: bert_train_stats["bias_launches"][k]
                 + (bert_fwd_launch[k] if k == "K1" else 0)
                 + elastic["bias_launches"][k]
                 + shard_stats["bert"]["bias_launches"][k]
                 for k in ("K1", "K2", "K3")}

    def row(name, source, replaces, keys, cases, head=None):
        by_path = {p: sum(n[k] for k in keys) for p, n in paths.items()}
        head = head or cases[0]
        # kernel_route: the bf16 main path's kernel (wgmma for all six),
        # with earlier_ms the FMA kernel's time on the same inputs.
        extra = {k: head[k] for k in ("kernel_route", "earlier_ms")
                 if k in head}
        bias = {}
        if keys[0] in bert_bias:
            # The bias variant: its launches (all on the BERT paths) and
            # its case at BERT-Large's shape with a padding bias.
            bias = dict(bias_launches=bert_bias[keys[0]],
                        bias_case=bias_cases[0][keys[0]])
            cases = cases + [c[keys[0]] for c in bias_cases]
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path, **bias,
                    **{k: head[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")}, **extra,
                    cases=cases)

    # K6's headline: one backward at the train gate/up shape, both halves.
    dlhs, tgmm = gmm_cases[0]["K6 dlhs"], gmm_cases[0]["K6 tgmm"]
    k6_head = dict(
        kernel_route=dlhs["kernel_route"],
        earlier_ms=dlhs["earlier_ms"] + tgmm["earlier_ms"],
        max_abs_err=max(dlhs["max_abs_err"], tgmm["max_abs_err"]),
        ms=dlhs["ms"] + tgmm["ms"], plain_ms=dlhs["plain_ms"]
        + tgmm["plain_ms"], bound_ms=dlhs["bound_ms"] + tgmm["bound_ms"],
        bound_by=dlhs["bound_by"],
        library_ms=None if None in (dlhs["library_ms"], tgmm["library_ms"])
        else dlhs["library_ms"] + tgmm["library_ms"])
    kernels = [
        row("K1 flash_fwd", "horovod_tpu_torch/csrc/flash_fwd_wgmma.cu",
            "horovod_tpu/ops/flash_attention.py:50", ["K1"], k1,
            head=k1[3]),
        row("K2 flash_bwd_dkv", "horovod_tpu_torch/csrc/flash_bwd_wgmma.cu",
            "horovod_tpu/ops/flash_attention.py:134", ["K2"], k2),
        row("K3 flash_bwd_dq",
            "horovod_tpu_torch/csrc/flash_bwd_dq_wgmma.cu",
            "horovod_tpu/ops/flash_attention.py:208", ["K3"], k3),
        row("K4 decode_attention",
            "horovod_tpu_torch/csrc/decode_attention_wgmma.cu",
            "horovod_tpu/ops/decode_attention.py:36", ["K4"], k4),
        row("K5 gmm", "horovod_tpu_torch/csrc/grouped_mm_wgmma.cu",
            "horovod_tpu/ops/grouped_moe.py:137", ["K5"], k5),
        row("K6 gmm_dlhs + tgmm",
            "horovod_tpu_torch/csrc/grouped_mm_wgmma.cu",
            "horovod_tpu/ops/grouped_moe.py:151", ["K6 dlhs", "K6 tgmm"],
            k6, head=k6_head),
    ]
    # The offsets variant (the Pallas offsets grid at :281): its launches
    # are phase 17's ring replay; its headline the past chunk (a full
    # 4096 x 4096 step, the work most ring steps do).
    for key, source in (("K1", "flash_fwd_wgmma.cu"),
                        ("K2", "flash_bwd_wgmma.cu"),
                        ("K3", "flash_bwd_dq_wgmma.cu")):
        head = offsets_cases[0][key]
        kernels.append(dict(
            name=f"{key} offsets", route="cuda",
            source=f"horovod_tpu_torch/csrc/{source}",
            replaces="horovod_tpu/ops/flash_attention.py:281",
            launches=ring["launches"][key],
            **{k: head[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_note", "kernel_route",
                "earlier_ms")},
            cases=[case[key] for case in offsets_cases]))
    kernels += codec_rows(wire)
    # The Adam kernel, one row a variant: its launches are the train
    # paths' (phase 22 (b) the master variant's, the rest the other's).
    adam_paths = {
        "adam": {**{p: n["Adam"] for p, n in paths.items() if n["Adam"]},
                 "zero_train_step": zero_launch["Adam adam"]},
        "master": {"zero_train_step": zero_launch["Adam master"],
                   "checkpointed_master_step":
                       ckpt_paths["checkpointed_master_step"][
                           "Adam master"]}}
    adam_launches = {v: sum(by.values()) for v, by in adam_paths.items()}
    check(adam_launches["adam"] > 0 and adam_launches["master"] > 0,
          f"the Adam kernel's variants launched {adam_launches} times on "
          "the main paths")
    for variant, label in (("adam", "moments in the parameter dtype"),
                           ("master", "f32 master, compute-dtype cast")):
        head = adam_stats[variant]
        kernels.append(dict(
            name=f"Adam update ({label})", route="cuda",
            source="horovod_tpu_torch/csrc/adam.cu",
            replaces="none: horovod_tpu/parallel/precision.py:118 "
                     "_adam_leaf, one XLA fusion (no Pallas kernel)",
            launches=adam_launches[variant],
            launches_by_path=adam_paths[variant],
            **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "library_note")},
            shape=f"{head['leaves']} flagship leaves, {head['params']} "
                  f"params, {head['dtypes']}"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == [WORKER_FLAG]:
            launched_worker(*sys.argv[2:4])
        elif sys.argv[1:2] == [SERVE_FLAG]:
            serve_worker(*sys.argv[2:4])
        else:
            main()
    except Exception as e:  # every failed phase ends the run, loudly
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
