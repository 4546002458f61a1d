"""The flash-decode kernel's split of the cache, and the C interface of the
port's kernels, on the CPU.

`decode_split(S, B, Hkv)` plans how many CTAs share each (batch row, kv
head)'s cache and how many rows each takes; the kernel relies on every
cache row below S falling in exactly one chunk of whole 64-row TMA tiles.
`test_split_merge_matches_reference` replays the kernel's arithmetic over
that plan in float32 on the CPU (a partial (m, l, acc) per chunk, an empty
one for a chunk at or past kv_len, then the fixed-order merge) and holds
it to the reference's Pallas kernel in interpret mode at the model zoo's
float32 tolerance, 2e-5.  The signature tests parse each kernel source's
extern "C" declarations: `build.SIGNATURES` must give every entry point
one ctypes type per C argument, c_void_p for each pointer, c_longlong for
each size, or ctypes would cut pointers and sizes at the call.
"""
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_decode import (MAX_SPLIT, MIN_CTAS, TILE_ROWS,
                                              decode_split)

PLANS = [(32768, 4, 8), (31744, 1, 8), (1, 1, 1), (63, 2, 3), (64, 1, 1),
         (65, 1, 1), (777, 2, 1), (1000, 3, 2), (2048, 4, 4), (4096, 2, 1),
         (9000, 2, 2), (300, 64, 64), (100000, 1, 1), (5_000_000, 1, 1)]


@pytest.mark.parametrize("S,B,Hkv", PLANS)
def test_every_cache_row_falls_in_exactly_one_chunk(S, B, Hkv):
    chunk, n_split = decode_split(S, B, Hkv)
    owners = np.zeros(S, np.int64)
    for i in range(n_split):
        owners[i * chunk:min((i + 1) * chunk, S)] += 1
    assert (owners == 1).all()
    # no chunk starts at or past S (the C entry point refuses such a plan)
    assert (n_split - 1) * chunk < S <= n_split * chunk


@pytest.mark.parametrize("S,B,Hkv", PLANS)
def test_chunks_are_whole_tiles(S, B, Hkv):
    chunk, _ = decode_split(S, B, Hkv)
    assert chunk >= TILE_ROWS and chunk % TILE_ROWS == 0


def test_real_shape_gives_two_waves():
    """llama3-8b's decode: S 32768, B 4, Hkv 8 -> at least two CTAs per SM
    of the card's 132."""
    chunk, n_split = decode_split(32768, 4, 8)
    assert 4 * 8 * n_split >= MIN_CTAS == 264
    assert (chunk, n_split) == (2048, 16)


@pytest.mark.parametrize("S", [1, 17, 63, 64])
def test_cache_shorter_than_a_chunk(S):
    assert decode_split(S, 1, 1) == (TILE_ROWS, 1)


def test_many_heads_keep_the_largest_chunk():
    """With B * Hkv alone past two waves the chunk stays at its maximum,
    so a short cache is one CTA per (b, kv head)."""
    assert decode_split(300, 64, 64) == (2048, 1)
    assert decode_split(5000, 64, 64) == (2048, 3)


@pytest.mark.parametrize("S,B,Hkv", PLANS)
def test_split_stays_within_the_merge(S, B, Hkv):
    """The merge kernel takes at most MAX_SPLIT partials per (b, kv head):
    a longer cache gets longer chunks."""
    assert decode_split(S, B, Hkv)[1] <= MAX_SPLIT


@pytest.mark.parametrize("S,B,Hkv", [(0, 1, 1), (8, 0, 1), (8, 1, 0)])
def test_split_refuses_empty_shapes(S, B, Hkv):
    with pytest.raises(ValueError):
        decode_split(S, B, Hkv)


def _split_merge(q, k, v, kv_len):
    """The kernel's arithmetic over decode_split's plan, in float32."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    chunk, n_split = decode_split(S, B, Hkv)
    qf = q.float().reshape(B, Hkv, G, D)
    out = torch.zeros(B, Hkv, G, D)
    for b in range(B):
        n = min(max(int(kv_len[b]), 0), S)
        m = torch.full((n_split, Hkv, G), -1e30)
        l = torch.zeros(n_split, Hkv, G)
        acc = torch.zeros(n_split, Hkv, G, D)
        for i in range(n_split):
            lo, hi = i * chunk, min((i + 1) * chunk, n)
            if lo >= hi:
                continue                              # an empty partial
            s = torch.einsum("hgd,shd->hgs", qf[b], k[b, lo:hi].float())
            s = s * (1.0 / math.sqrt(D))
            m[i] = s.amax(-1)
            p = torch.exp(s - m[i][..., None])
            l[i] = p.sum(-1)
            acc[i] = torch.einsum("hgs,shd->hgd", p, v[b, lo:hi].float())
        M = m.amax(0)
        w = torch.exp(m - M)
        out[b] = (acc * w[..., None]).sum(0) / \
            torch.clamp((l * w).sum(0), min=1e-30)[..., None]
    return out.reshape(B, Hq, D)


# kv_len > S only where S is a multiple of block_s: the reference pads the
# cache to one with zero rows, which such a kv_len would read
@pytest.mark.parametrize("B,Hq,Hkv,D,S,kv_len", [
    (4, 4, 2, 32, 777, [65, 64, 10, 777]),     # chunk 64: one row past a
                                               # boundary, on one, short
    (3, 8, 2, 64, 1024, [0, 5000, 129]),       # 0 beside S, above S
    (2, 5, 1, 32, 130, [129, 1]),              # G 5, S not a multiple of 64
])
def test_split_merge_matches_reference(B, Hq, Hkv, D, S, kv_len):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    rng = np.random.default_rng(S + D)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in [(B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)])
    kl = np.array(kv_len, np.int32)
    got = _split_merge(*(torch.from_numpy(x) for x in (q, k, v)), kl)
    # the reference on JAX's CPU device, in float32 (a GPU would take its
    # products at reduced precision)
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(ref_ops.flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kl),
            block_s=64))
    # the Pallas kernel's kv_len <= 0 rows: zeros, as the merge gives
    assert np.abs(got.numpy() - want).max() < 2e-5
    plain = ops.flash_decode_plain(*(torch.from_numpy(x)
                                     for x in (q, k, v)), torch.from_numpy(kl))
    assert float((got - plain).abs().max()) < 2e-5


def _c_entry_points(name):
    src = (build.CSRC / f"{name}.cu").read_text()
    return re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)


@pytest.mark.parametrize("name", build.SOURCES)
def test_signatures_match_the_c_entry_points(name):
    decls = _c_entry_points(name)
    assert [fn for fn, _ in decls] == list(build.SIGNATURES[name])
    for fn, args in decls:
        want = [build._VP if "*" in a else build._LL
                for a in args.split(",")]
        assert all("*" in a or "long long" in a for a in args.split(",")), fn
        assert list(build.SIGNATURES[name][fn]) == want, fn
