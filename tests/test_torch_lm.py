"""The port's LM serving path against the reference package, on the CPU.

The same inputs, made with numpy from a seed, go through the reference's
JAX function and the port's counterpart: the layers (`rms_norm`,
`apply_rope`, `causal_attention` in both branches), the plain versions of
the two attention kernels against the reference's Pallas kernels in
interpret mode, and, with the reference's `init_params` weights carried by
`lm_params_from_reference`, `forward`, `forward_with_cache`, eight
`decode_step`s with either attention and the greedy `serve_lm` loop of the
llama3-8b, qwen2.5-32b, granite-moe-1b-a400m and moonshot-v1-16b-a3b smoke
configs (the MoE layers dropless, as the reference serves them).  Tolerances are the model zoo's:
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
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

TOL = {np.float32: 2e-5, "bf16": 5e-2}
DTYPES = {np.float32: (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LM_ARCHS = ["llama3-8b", "qwen2.5-32b", "granite-moe-1b-a400m",
            "moonshot-v1-16b-a3b"]


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


def _ref_router_probs(h, router):
    """The reference router's float32 probabilities of tokens h [..., D]
    (compute dtype) under router [D, E] (float32), as `moe_ffn` takes
    them."""
    logits = jnp.einsum("...d,de->...e", h, jnp.asarray(router).astype(h.dtype),
                        preferred_element_type=jnp.float32)
    return np.array(jax.nn.softmax(logits, axis=-1))


def test_bf16_forward_matches_reference(lm, monkeypatch):
    """bf16 logits within 5e-2 of the reference's.  An MoE router's top-k
    is discontinuous: bf16 rounding upstream can swap the K-th and
    (K+1)-th expert of a token whose probabilities nearly tie, which moves
    that token's output by O(1).  So for MoE models each layer's routing is
    compared too (the reference's own layer inputs, read back by a debug
    callback): every token routed differently must be a near tie
    (`moe.routing_differences`), and positions at or after such a token in
    its row are left out of the logit check."""
    ref_cfg = dataclasses.replace(lm["ref_cfg"], dtype=jnp.bfloat16)
    cfg = dataclasses.replace(lm["cfg"], dtype=torch.bfloat16)
    model = lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, lm["params"]), cfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    ref_h, port_routes = [], []
    if cfg.moe:
        ref_moe_ffn, port_route = ref_tfm.moe_ffn, moe.route

        def ref_recording(h, *args, **kw):
            jax.debug.callback(lambda v: ref_h.append(np.asarray(v)), h,
                               ordered=True)
            return ref_moe_ffn(h, *args, **kw)

        def port_recording(xg, router_w, mcfg):
            out = port_route(xg, router_w, mcfg)
            port_routes.append(out)
            return out
        monkeypatch.setattr(ref_tfm, "moe_ffn", ref_recording)
        monkeypatch.setattr(moe, "route", port_recording)
    want, _ = ref_tfm.forward(ref_cfg, lm["params"], jnp.asarray(lm["toks"]))
    got = tfm.forward(model, torch.from_numpy(lm["toks"]).long())
    B, S = lm["toks"].shape
    compared = np.ones((B, S), bool)
    if cfg.moe:
        assert len(ref_h) == len(port_routes) == cfg.n_layers
        for layer, h, (probs, _, idx) in zip(model.layers, ref_h, port_routes):
            p_ref = torch.from_numpy(_ref_router_probs(
                jnp.asarray(h), layer.router.numpy())).reshape(probs.shape)
            idx_ref = torch.sort(p_ref, dim=-1, descending=True,
                                 stable=True).indices[..., :cfg.moe.top_k]
            differs, gap, near = moe.routing_differences(p_ref, idx_ref,
                                                         probs, idx)
            assert bool(near[differs].all()), (gap[differs], near[differs])
            for b, s in zip(*np.nonzero(differs.reshape(B, S).numpy())):
                compared[b, s:] = False
        assert compared.sum() >= B * S // 2
    err = np.abs(np.asarray(jnp.asarray(want, jnp.float32))
                 - got.float().numpy()).max(-1)
    assert float(err[compared].max()) < TOL["bf16"]


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

@pytest.mark.parametrize("arch", ["llama3-8b", "granite-3-8b", "qwen2.5-32b",
                                  "granite-moe-1b-a400m",
                                  "moonshot-v1-16b-a3b"])
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
        assert cfg.active_param_count() == ref.active_param_count()
        assert cfg.vocab_padded == ref.vocab_padded
        assert cfg.attn_chunk == layers.AttnChunking(
            **dataclasses.asdict(ref.attn_chunk))
        assert (cfg.moe is None) == (ref.moe is None)
        if ref.moe is not None:
            for f in dataclasses.fields(cfg.moe):
                assert getattr(cfg.moe, f.name) == getattr(ref.moe, f.name), \
                    (arch, make, f.name)


@pytest.mark.parametrize("arch", ["gin-tu"])
def test_gnn_config_matches_reference(arch):
    """The GNN the port now registers: its configs' fields and parameter
    count, family and shape set are the reference's."""
    from repro.configs.registry import GNN_SHAPES as REF_GNN_SHAPES
    from repro_torch.configs.registry import GNN_SHAPES
    spec, ref_spec = get_arch(arch), ref_get_arch(arch)
    assert spec.family == ref_spec.family == "gnn"
    assert spec.shapes == GNN_SHAPES == REF_GNN_SHAPES
    for make in ("make_config", "make_smoke_config"):
        ref = getattr(ref_spec, make)()
        cfg = getattr(spec, make)()
        for f in ("name", "n_layers", "d_hidden", "d_feat", "n_classes",
                  "graph_readout", "message_dtype"):
            assert getattr(cfg, f) == getattr(ref, f), (arch, make, f)
        for f in ("dtype", "param_dtype"):
            assert (str(getattr(cfg, f)).split(".")[-1]
                    == jnp.dtype(getattr(ref, f)).name), (arch, make, f)
        assert cfg.param_count() == ref.param_count()
