"""The port's LM serving path against the reference package, on the CPU.

The same inputs, made with numpy from a seed, go through the reference's
JAX function and the port's counterpart: the layers (`rms_norm`,
`apply_rope`, `causal_attention` in both branches), the plain versions of
the two attention kernels against the reference's Pallas kernels in
interpret mode, and, with the reference's `init_params` weights carried by
`lm_params_from_reference`, `forward`, `forward_with_cache`, eight
`decode_step`s with either attention and the greedy `serve_lm` loop of the
llama3-8b and qwen2.5-32b smoke configs.  Tolerances are the model zoo's:
2e-5 in float32, 5e-2 in bf16 (tests/test_kernels.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as ref_get_arch  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.launch.steps import forward_with_cache as ref_forward_with_cache  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro_torch.carry import lm_params_from_reference  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import serve_lm  # noqa: E402
from repro_torch.launch.steps import forward_with_cache  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

TOL = {np.float32: 2e-5, "bf16": 5e-2}
DTYPES = {np.float32: (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LM_ARCHS = ["llama3-8b", "qwen2.5-32b"]


def _pair(x, dt):
    """numpy x as (jax array, torch tensor) of the same dtype `dt`."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(np.asarray(x, np.float32)).to(tdt)


def _err(a, b) -> float:
    a = np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [np.float32, "bf16"])
def test_rms_norm_matches_reference(dt):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(2, 5, 128)) * 3, dt)
    sj, st = _pair(rng.normal(size=(128,)), dt)
    assert _err(ref_layers.rms_norm(xj, sj), layers.rms_norm(xt, st)) < TOL[dt]


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0, 1_000_000.0])
@pytest.mark.parametrize("dt", [np.float32, "bf16"])
def test_apply_rope_matches_reference(theta, dt):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.normal(size=(2, 40, 3, 32)), dt)
    pos = np.arange(40, dtype=np.int32)[None, :] + 70
    got = layers.apply_rope(xt, torch.from_numpy(pos), theta)
    want = ref_layers.apply_rope(xj, jnp.asarray(pos), theta)
    assert _err(want, got) < TOL[dt]


@pytest.mark.parametrize("dt", [np.float32, "bf16"])
@pytest.mark.parametrize("S,Hq,Hkv,chunking", [
    (48, 4, 1, layers.AttnChunking()),                   # full S x S
    (256, 8, 2, layers.AttnChunking(threshold=64, chunk_q=64, chunk_kv=32)),
    (256, 5, 1, layers.AttnChunking(threshold=128, chunk_q=128,
                                    chunk_kv=128)),
])
def test_causal_attention_matches_reference(S, Hq, Hkv, chunking, dt):
    rng = np.random.default_rng(S + Hq)
    qj, qt = _pair(rng.normal(size=(2, S, Hq, 32)), dt)
    kj, kt = _pair(rng.normal(size=(2, S, Hkv, 32)), dt)
    vj, vt = _pair(rng.normal(size=(2, S, Hkv, 32)), dt)
    cq, ckv = chunking.for_seq(S)
    got = layers.causal_attention(qt, kt, vt, chunk_q=cq, chunk_kv=ckv)
    want = ref_layers.causal_attention(qj, kj, vj, chunk_q=cq, chunk_kv=ckv)
    assert got.dtype == qt.dtype
    assert _err(want, got) < TOL[dt]


# ---------------------------------------------------------------------------
# the two attention kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hq,Hkv,D,S,kv_len,dt", [
    (2, 4, 4, 32, 96, [1, 96], np.float32),              # G = 1; 1 and S
    (2, 8, 2, 64, 100, [37, 73], np.float32),            # G = 4, S % 32 != 0
    (1, 5, 1, 128, 64, [63], np.float32),                # G = 5
    (3, 8, 2, 128, 160, [0, 160, 33], np.float32),       # kv_len 0
    (2, 8, 2, 64, 128, [77, 128], "bf16"),
    (2, 5, 1, 32, 70, [0, 41], "bf16"),
])
def test_flash_decode_plain_matches_pallas(B, Hq, Hkv, D, S, kv_len, dt):
    rng = np.random.default_rng(B * S + D)
    qj, qt = _pair(rng.normal(size=(B, Hq, D)), dt)
    kj, kt = _pair(rng.normal(size=(B, S, Hkv, D)), dt)
    vj, vt = _pair(rng.normal(size=(B, S, Hkv, D)), dt)
    kl = np.asarray(kv_len, np.int32)
    want = ref_ops.flash_decode(qj, kj, vj, jnp.asarray(kl), block_s=32,
                                implementation="pallas", interpret=True)
    got = ops.flash_decode(qt, kt, vt, torch.from_numpy(kl))
    assert got.dtype == qt.dtype
    assert _err(want, got) < TOL[dt]
    # kv_len 0: zeros, as the Pallas kernel (the reference's ref gives NaN)
    assert not got[torch.from_numpy(kl) == 0].float().abs().any()


def test_flash_decode_plain_clamps_kv_len_and_takes_a_scalar():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 24, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 24, 2, 32)).astype(np.float32))
    full = ops.flash_decode(q, k, v, 24)
    assert torch.equal(ops.flash_decode(q, k, v, torch.tensor([99, 24],
                                                              dtype=torch.int32)),
                       full)
    want = ref_ops.flash_decode(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                24, implementation="ref")
    assert _err(want, full) < TOL[np.float32]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,block,dt", [
    (1, 128, 4, 1, 32, 32, np.float32),
    (2, 96, 8, 2, 64, 32, np.float32),
    (1, 256, 4, 2, 128, 64, np.float32),
    (1, 128, 8, 2, 64, 64, "bf16"),
])
def test_flash_prefill_plain_matches_pallas(B, S, Hq, Hkv, D, block, dt):
    rng = np.random.default_rng(B * S + D)
    qj, qt = _pair(rng.normal(size=(B, S, Hq, D)), dt)
    kj, kt = _pair(rng.normal(size=(B, S, Hkv, D)), dt)
    vj, vt = _pair(rng.normal(size=(B, S, Hkv, D)), dt)
    want = ref_ops.flash_prefill(qj, kj, vj, block_q=block, block_kv=block,
                                 implementation="pallas", interpret=True)
    got = ops.flash_prefill(qt, kt, vt)
    assert got.dtype == qt.dtype
    assert _err(want, got) < TOL[dt]


def test_flash_prefill_plain_matches_model_attention():
    """Three-way: the plain prefill equals the port's chunked
    `causal_attention`, as the reference's kernel equals its own."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 256, h, 64))
                                .astype(np.float32)) for h in (8, 2, 2))
    a = ops.flash_prefill(q, k, v)
    b = layers.causal_attention(q, k, v, chunk_q=64, chunk_kv=64)
    assert float((a - b).abs().max()) < TOL[np.float32]


# ---------------------------------------------------------------------------
# the model, with the reference's weights carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=LM_ARCHS)
def lm(request):
    arch = request.param
    ref_cfg = ref_get_arch(arch).make_smoke_config()
    cfg = get_arch(arch).make_smoke_config()
    params = ref_tfm.init_params(ref_cfg, jax.random.PRNGKey(0))
    model = lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    return {"arch": arch, "ref_cfg": ref_cfg, "cfg": cfg, "params": params,
            "model": model, "toks": toks}


def test_carried_weights_equal_reference(lm):
    lp = lm["params"]["layers"]
    for i, layer in enumerate(lm["model"].layers):
        for name, p in layer.named_parameters():
            assert np.array_equal(p.numpy(), np.asarray(lp[name][i])), name
    assert np.array_equal(lm["model"].lm_head.numpy(),
                          np.asarray(lm["params"]["lm_head"]))


def test_forward_matches_reference(lm):
    want, _ = ref_tfm.forward(lm["ref_cfg"], lm["params"],
                              jnp.asarray(lm["toks"]))
    got = tfm.forward(lm["model"], torch.from_numpy(lm["toks"]).long())
    assert got.dtype == torch.float32
    assert _err(want, got) < TOL[np.float32]


def test_forward_with_cache_matches_reference(lm):
    want, wcache = ref_forward_with_cache(lm["ref_cfg"], lm["params"],
                                          jnp.asarray(lm["toks"]))
    got, cache = forward_with_cache(lm["model"],
                                    torch.from_numpy(lm["toks"]).long())
    assert _err(want, got) < TOL[np.float32]
    for f in ("k", "v"):
        assert _err(wcache[f], cache[f]) < TOL[np.float32]


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_decode_steps_match_reference(lm, impl):
    ref_cfg, model, toks = lm["ref_cfg"], lm["model"], lm["toks"]
    step = jax.jit(lambda p, c, t, i: ref_tfm.decode_step(
        ref_cfg, p, c, t, i, attn_impl=impl))
    rc = ref_tfm.init_cache(ref_cfg, 2, 16)
    pc = tfm.init_cache(lm["cfg"], 2, 16, device="cpu")
    for t in range(8):
        want, rc = step(lm["params"], rc, jnp.asarray(toks[:, t]),
                        jnp.int32(t))
        got, pc = tfm.decode_step(model, pc, torch.from_numpy(toks[:, t]).long(),
                                  t, attn_impl=impl)
        assert _err(want, got) < TOL[np.float32], t
    for f in ("k", "v"):
        assert _err(rc[f], pc[f]) < TOL[np.float32]


def test_decode_matches_forward(lm):
    """The port's own consistency check (tests/test_models.py's): eight
    decode steps give the logits of one forward pass."""
    model, toks = lm["model"], torch.from_numpy(lm["toks"][:, :8]).long()
    cache = tfm.init_cache(lm["cfg"], 2, 16, device="cpu")
    outs = []
    for t in range(8):
        lg, cache = tfm.decode_step(model, cache, toks[:, t], t,
                                    attn_impl="flash")
        outs.append(lg)
    full = tfm.forward(model, toks)
    assert float((torch.stack(outs, dim=1) - full).abs().max()) < 5e-3


def test_decode_past_the_cache_overwrites_the_last_slot(lm):
    """cur_len >= Smax writes slot Smax - 1, as `dynamic_update_slice`
    clamps its start index, and attention reads all Smax rows."""
    ref_cfg, model, toks = lm["ref_cfg"], lm["model"], lm["toks"]
    rc = ref_tfm.init_cache(ref_cfg, 2, 4)
    pc = tfm.init_cache(lm["cfg"], 2, 4, device="cpu")
    for t in range(6):
        want, rc = ref_tfm.decode_step(ref_cfg, lm["params"], rc,
                                       jnp.asarray(toks[:, t]), jnp.int32(t))
        got, pc = tfm.decode_step(model, pc, torch.from_numpy(toks[:, t]).long(),
                                  t)
        assert _err(want, got) < TOL[np.float32], t
    assert _err(rc["k"], pc["k"]) < TOL[np.float32]


def test_flash_prefill_path_matches_reference_prefill(lm):
    """The flash prefill on each layer's q, k, v equals that layer's own
    attention in the prefill (as chip_smoke.py holds the kernel against the
    model on the card), and the prefill built from those layers equals the
    reference's."""
    want, wcache = ref_forward_with_cache(lm["ref_cfg"], lm["params"],
                                          jnp.asarray(lm["toks"]))
    model = lm["model"]
    toks = torch.from_numpy(lm["toks"]).long()
    x = model.embed[toks]
    pos = torch.arange(toks.shape[1], dtype=torch.int32)[None]
    for layer, ref_v in zip(model.layers, np.asarray(wcache["v"])):
        q, k, v = layer.qkv(x, pos)
        o = layers.causal_attention(q, k, v)
        assert float((ops.flash_prefill(q, k, v) - o).abs().max()) < TOL[np.float32]
        assert _err(ref_v, v) < TOL[np.float32]
        x = layer.attn_out(x, o)
    assert _err(want, model.logits(x[:, -1])) < TOL[np.float32]


def test_bf16_forward_matches_reference(lm):
    ref_cfg = dataclasses.replace(lm["ref_cfg"], dtype=jnp.bfloat16)
    cfg = dataclasses.replace(lm["cfg"], dtype=torch.bfloat16)
    model = lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, lm["params"]), cfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    want, _ = ref_tfm.forward(ref_cfg, lm["params"], jnp.asarray(lm["toks"]))
    got = tfm.forward(model, torch.from_numpy(lm["toks"]).long())
    assert _err(want, got) < TOL["bf16"]


def test_serve_lm_matches_reference_loop(lm, capsys, monkeypatch):
    """The port's greedy serve loop (flash decode) gives the first ten
    tokens of the reference's `serve_lm` loop on the same weights (the
    carried ones, in place of the port's own `init_params`)."""
    ref_cfg, cfg = lm["ref_cfg"], lm["cfg"]
    step = jax.jit(lambda p, c, t, i: ref_tfm.decode_step(ref_cfg, p, c, t, i))
    cache = ref_tfm.init_cache(ref_cfg, 2, 128)
    tok = jnp.zeros((2,), jnp.int32)
    want = []
    for i in range(10):
        logits, cache = step(lm["params"], cache, tok, jnp.int32(i))
        tok = jnp.argmax(logits[:, :ref_cfg.vocab], axis=-1).astype(jnp.int32)
        want.append(int(tok[0]))
    monkeypatch.setattr(tfm, "init_params", lambda c, g, d: lm["model"])
    got = serve_lm(lm["arch"], 10, device="cpu")
    assert got == want
    assert f"first 10: {want}" in capsys.readouterr().out
    assert cfg.vocab == ref_cfg.vocab


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "granite-3-8b", "qwen2.5-32b"])
def test_configs_match_reference(arch):
    for make in ("make_config", "make_smoke_config"):
        ref = getattr(ref_get_arch(arch), make)()
        cfg = getattr(get_arch(arch), make)()
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "qkv_bias", "rope_theta",
                  "tie_embeddings"):
            assert getattr(cfg, f) == getattr(ref, f), (arch, make, f)
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(ref.dtype).name
        assert cfg.param_count() == ref.param_count()
        assert cfg.vocab_padded == ref.vocab_padded
        assert cfg.attn_chunk == layers.AttnChunking(
            **dataclasses.asdict(ref.attn_chunk))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b",
                                  "gin-tu"])
def test_unported_archs_raise_naming_the_roadmap(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_arch(arch)


def test_moe_config_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfm.TransformerConfig(name="m", n_layers=1, d_model=8, n_heads=1,
                              n_kv_heads=1, d_ff=8, vocab=8, moe=object())
