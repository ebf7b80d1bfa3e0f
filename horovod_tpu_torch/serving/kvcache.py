"""Paged KV cache: a fixed-size block pool with a free-list allocator.

The port's own copy of horovod_tpu/serving/kvcache.py (see its
docstring for the design): the cache is a pool of ``block_size``-slot
blocks, each covering all layers and kv heads of those slots, and a
sequence holds an ordered block table that grows one block at a time.
Optional int8 blocks keep one f32 scale per (block, layer, kv head):
quantize on write, dequantize with f32 accumulation on read.

Storage is torch tensors on the host, as the JAX pool is host-resident
numpy by design: the pool is control-plane state, and the decode step
moves a gathered view to the device once per step. Rounding is
``torch.round`` (half to even, like ``np.rint``), so the int8 bytes
equal the JAX copy's. :meth:`PagedKVCache.write_raw` and
:meth:`PagedKVCache.read_raw` are the prefill->decode wire path of the
multi-rank service (``serving/service.py``): pool-format blocks in and
out, adopted verbatim.
"""

import torch


class OutOfBlocks(RuntimeError):
    """The pool cannot satisfy an allocation (caller evicts or queues)."""


def _quantize(x, scale):
    """int8 payload of f32 ``x`` under per-row ``scale`` [..., L, Hkv]
    (rows of zero scale quantize under 1.0)."""
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(x.float() / safe[..., None, None])
    return q.clamp(-127, 127).to(torch.int8)


def quantize_blocks(k, v, block_size, quantized=True,
                    dtype=torch.float32):
    """Freeze k/v [L, Hkv, T, D] into pool-format blocks.

    Returns (k_q, v_q [n, L, Hkv, block_size, D], k_scale, v_scale
    [n, L, Hkv] — None unquantized). Same recipe as a fresh-block
    :meth:`PagedKVCache.write` (per-block amax/127, zero padding)."""
    n_layers, n_kv_heads, t, head_dim = k.shape
    n = max(1, -(-t // block_size))
    s_pad = n * block_size

    def to_blocks(x):
        out = torch.zeros((n_layers, n_kv_heads, s_pad, head_dim),
                          dtype=x.dtype)
        out[:, :, :t, :] = x
        # [L, Hkv, n, bs, D] -> [n, L, Hkv, bs, D]
        return out.reshape(n_layers, n_kv_heads, n, block_size,
                           head_dim).permute(2, 0, 1, 3, 4).contiguous()

    kb = to_blocks(torch.as_tensor(k).cpu())
    vb = to_blocks(torch.as_tensor(v).cpu())
    if not quantized:
        return kb.to(dtype), vb.to(dtype), None, None

    def quant(xb):
        scale = xb.abs().amax(dim=(-2, -1)).float() / 127.0   # [n, L, Hkv]
        return _quantize(xb, scale), scale

    k_q, k_s = quant(kb)
    v_q, v_s = quant(vb)
    return k_q, v_q, k_s, v_s


class PagedKVCache:
    """Block pool + allocator for K and V of every layer.

    ``k_pool[b]``/``v_pool[b]`` are [n_layers, n_kv_heads, block_size,
    head_dim]: one block covers ``block_size`` consecutive positions of
    ONE sequence across all layers and heads, so a sequence's cache is
    its block table concatenated along the position axis.
    """

    def __init__(self, n_layers, n_kv_heads, head_dim, block_size=16,
                 n_blocks=256, dtype=torch.float32, quantized=False):
        self.n_layers = int(n_layers)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.n_blocks = int(n_blocks)
        self.quantized = bool(quantized)
        shape = (self.n_blocks, self.n_layers, self.n_kv_heads,
                 self.block_size, self.head_dim)
        store = torch.int8 if quantized else dtype
        self.k_pool = torch.zeros(shape, dtype=store)
        self.v_pool = torch.zeros(shape, dtype=store)
        if quantized:
            sshape = (self.n_blocks, self.n_layers, self.n_kv_heads)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32)
            self.v_scale = torch.zeros(sshape, dtype=torch.float32)
        else:
            self.k_scale = self.v_scale = None
        # LIFO free list: recently-freed blocks are cache-warm.
        self._free = list(range(self.n_blocks - 1, -1, -1))
        self._allocated = set()

    # ---- allocator ----------------------------------------------------

    @property
    def blocks_free(self):
        return len(self._free)

    @property
    def blocks_total(self):
        return self.n_blocks

    def blocks_for(self, n_tokens):
        """Blocks needed to hold ``n_tokens`` positions."""
        return max(1, -(-int(n_tokens) // self.block_size))

    def alloc(self, n):
        """Take ``n`` blocks off the free list (all-or-nothing); raises
        :class:`OutOfBlocks` when fewer are free."""
        if n > len(self._free):
            raise OutOfBlocks(
                f"need {n} blocks, {len(self._free)} free "
                f"of {self.n_blocks}")
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        if self.quantized:
            # A handed-out block must be scale-fresh: a reused block
            # carrying its previous owner's larger scale would quantize
            # the new owner's first write differently from
            # quantize_blocks (see the JAX copy for the failure it
            # caused).
            idx = torch.tensor(out, dtype=torch.int64)
            self.k_scale[idx] = 0.0
            self.v_scale[idx] = 0.0
        return out

    def free(self, blocks):
        """Return blocks to the pool; freeing a block twice raises."""
        for blk in blocks:
            if blk not in self._allocated:
                raise ValueError(f"double free of block {blk}")
            self._allocated.discard(blk)
            self._free.append(blk)

    # ---- block I/O ----------------------------------------------------

    def write(self, blocks, pos, k, v):
        """Write ``k``/``v`` [L, Hkv, T, D] at sequence positions
        ``pos .. pos+T-1`` into the block table ``blocks``; quantized
        writes are block-granular (one scale update per touched block
        per call)."""
        k, v = torch.as_tensor(k).cpu(), torch.as_tensor(v).cpu()
        t = k.shape[2]
        i = 0
        while i < t:
            p = pos + i
            blk = blocks[p // self.block_size]
            off = p % self.block_size
            run = min(t - i, self.block_size - off)
            ks = k[:, :, i:i + run, :]
            vs = v[:, :, i:i + run, :]
            if self.quantized:
                self._write_block_q(blk, off, ks, vs)
            else:
                self.k_pool[blk, :, :, off:off + run, :] = ks
                self.v_pool[blk, :, :, off:off + run, :] = vs
            i += run

    def _write_block_q(self, blk, off, k_strip, v_strip):
        """Quantized write of a strip [L, Hkv, run, D] at slot ``off``;
        existing entries are requantized when the strip's amax grows
        the block scale."""
        run = k_strip.shape[2]
        for pool, scales, strip in ((self.k_pool, self.k_scale, k_strip),
                                    (self.v_pool, self.v_scale, v_strip)):
            new_scale = strip.abs().amax(dim=(-2, -1)).float() / 127.0
            old = scales[blk]
            grow = new_scale > old
            if bool(grow.any()):
                merged = torch.where(grow, new_scale, old)
                safe = torch.where(merged > 0, merged,
                                   torch.ones_like(merged))
                ratio = torch.where(old > 0, old,
                                    torch.zeros_like(old)) / safe
                pool[blk] = torch.round(
                    pool[blk].float() * ratio[:, :, None, None]).to(
                        torch.int8)
                scales[blk] = merged
            pool[blk, :, :, off:off + run, :] = _quantize(strip,
                                                          scales[blk])

    def write_raw(self, blocks, k_q, v_q, k_scale=None, v_scale=None):
        """Adopt pool-format payloads wholesale (the prefill->decode
        wire path): ``k_q``/``v_q`` [n, L, Hkv, bs, D] in the pool's
        storage dtype (int8 when quantized), scales [n, L, Hkv] (quantized
        pools only); tensors or numpy arrays."""
        idx = torch.tensor(blocks, dtype=torch.int64)
        self.k_pool[idx] = torch.as_tensor(k_q).to(self.k_pool.dtype)
        self.v_pool[idx] = torch.as_tensor(v_q).to(self.v_pool.dtype)
        if self.quantized:
            self.k_scale[idx] = torch.as_tensor(k_scale, dtype=torch.float32)
            self.v_scale[idx] = torch.as_tensor(v_scale, dtype=torch.float32)

    def read_raw(self, blocks):
        """Pool-format payloads of ``blocks`` (the wire's send side):
        ``(k_q, v_q, k_scale, v_scale)``, the scales None unquantized."""
        idx = torch.tensor(blocks, dtype=torch.int64)
        k_q, v_q = self.k_pool[idx], self.v_pool[idx]
        if self.quantized:
            return k_q, v_q, self.k_scale[idx], self.v_scale[idx]
        return k_q, v_q, None, None

    def gather(self, blocks, pad_blocks=0):
        """Concatenate a block table into the attention view.

        Returns (k, v, k_scale, v_scale): k/v
        [L, Hkv, (len(blocks)+pad_blocks)*block_size, D] in the pool's
        storage dtype, zero-padded; scales per slot [L, Hkv, S] for
        quantized pools (the block scale repeated over its slots), None
        otherwise — what ``decode_attention_ragged(k_scale=...)``
        takes."""
        idx = torch.tensor(blocks, dtype=torch.int64)
        n = len(blocks) + int(pad_blocks)
        s_pad = n * self.block_size
        shape = (self.n_layers, self.n_kv_heads, s_pad, self.head_dim)
        k = torch.zeros(shape, dtype=self.k_pool.dtype)
        v = torch.zeros(shape, dtype=self.v_pool.dtype)
        valid = len(blocks) * self.block_size
        if len(blocks):
            # [n, L, Hkv, bs, D] -> [L, Hkv, n*bs, D]
            k[:, :, :valid, :] = self.k_pool[idx].permute(
                1, 2, 0, 3, 4).reshape(self.n_layers, self.n_kv_heads,
                                       valid, self.head_dim)
            v[:, :, :valid, :] = self.v_pool[idx].permute(
                1, 2, 0, 3, 4).reshape(self.n_layers, self.n_kv_heads,
                                       valid, self.head_dim)
        if not self.quantized:
            return k, v, None, None
        ks = torch.zeros((self.n_layers, self.n_kv_heads, s_pad),
                         dtype=torch.float32)
        vs = torch.zeros_like(ks)
        if len(blocks):
            ks[:, :, :valid] = self.k_scale[idx].permute(
                1, 2, 0).repeat_interleave(self.block_size, dim=-1)
            vs[:, :, :valid] = self.v_scale[idx].permute(
                1, 2, 0).repeat_interleave(self.block_size, dim=-1)
        return k, v, ks, vs

    def stats(self):
        """The pool's serving signals."""
        return {"kv_blocks_free": self.blocks_free,
                "kv_blocks_total": self.blocks_total}
