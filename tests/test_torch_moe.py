"""The port's MoE layer (src/repro_torch/models/moe.py) against the
reference's (src/repro/models/moe.py), on the CPU.

The same inputs, made with numpy from a seed, go through `moe_ffn`,
`router_aux_loss` and the per-group dispatch of both packages: dropless
and capacity dispatch (with assignments dropped), one, two and a
non-dividing number of groups, gates normalised or not, exact ties in the
router, 2-D and 3-D tokens.  Float32 to 2e-5; one bf16 case to 5e-2 on
inputs whose router has no near tie.  The reference has no Pallas kernel
here: its `moe_ffn` runs as its own tests run it, eagerly on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

TOL = {np.float32: 2e-5, "bf16": 5e-2}
E, K, D, FE = 8, 2, 32, 48


def _weights(rng):
    router = (rng.normal(size=(D, E)) * 0.3).astype(np.float32)
    wg, wu = ((rng.normal(size=(E, D, FE)) * D ** -0.5).astype(np.float32)
              for _ in range(2))
    wd = (rng.normal(size=(E, FE, D)) * FE ** -0.5).astype(np.float32)
    return router, wg, wu, wd


def _configs(**kw):
    return ref_moe.MoEConfig(n_experts=E, top_k=K, d_expert=FE, **kw), \
        moe.MoEConfig(n_experts=E, top_k=K, d_expert=FE, **kw)


def _both(x, weights, kw, dropless, dt=np.float32):
    ref_cfg, cfg = _configs(**kw)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == np.float32
                else (jnp.bfloat16, torch.bfloat16))
    want_y, want_aux = ref_moe.moe_ffn(
        jnp.asarray(x, jdt), *(jnp.asarray(w) for w in weights), ref_cfg, jdt,
        dropless=dropless)
    got_y, got_aux = moe.moe_ffn(
        torch.from_numpy(x).to(tdt), *(torch.from_numpy(w).to(
            torch.float32 if i == 0 else tdt) for i, w in enumerate(weights)),
        cfg, tdt, dropless=dropless)
    assert got_y.dtype == tdt and got_y.shape == x.shape
    assert got_aux.dtype == torch.float32
    return (np.asarray(jnp.asarray(want_y, jnp.float32)), float(want_aux),
            got_y.float().numpy(), float(got_aux))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("n_groups", [1, 2, 4])     # 4 does not divide 6
@pytest.mark.parametrize("dropless", [True, False])
def test_moe_ffn_matches_reference(dropless, n_groups, normalize):
    rng = np.random.default_rng(10 * n_groups + dropless + 2 * normalize)
    x = rng.normal(size=(6, 5, D)).astype(np.float32)          # 3-D tokens
    weights = _weights(rng)
    kw = dict(n_groups=n_groups, normalize_gates=normalize,
              capacity_factor=0.5)
    wy, wa, gy, ga = _both(x, weights, kw, dropless)
    assert np.abs(wy - gy).max() < TOL[np.float32]
    assert abs(wa - ga) < TOL[np.float32]


def test_capacity_dispatch_drops_as_the_reference():
    """At capacity factor 0.5 some assignments are really dropped (the
    trash row), and the port drops the same ones: the dispatch tables of
    every group equal the reference's `_dispatch_group`'s."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 20, D)).astype(np.float32)
    router = _weights(rng)[0]
    _, cfg = _configs(n_groups=2, capacity_factor=0.5)
    xg = torch.from_numpy(x)
    _, _, gate_idx = moe.route(xg, torch.from_numpy(router), cfg)
    C = int((20 * K / E) * 0.5) + 1
    slot, keep, token, order = moe.dispatch(gate_idx, C, E)
    assert not bool(keep.all())                    # something is dropped
    assert bool((slot[~keep] == E * C).all())
    for g in range(2):
        want = ref_moe._dispatch_group(jnp.asarray(x[g]),
                                       jnp.asarray(gate_idx[g].numpy()), C, E,
                                       K)
        for w, t in zip(want, (slot[g], keep[g], token[g], order[g])):
            assert np.array_equal(np.asarray(w), t.numpy())


def test_moe_ffn_two_dim_tokens_and_router_aux_loss():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(12, D)).astype(np.float32)            # 2-D tokens
    weights = _weights(rng)
    for dropless in (True, False):
        wy, wa, gy, ga = _both(x, weights, dict(n_groups=3), dropless)
        assert np.abs(wy - gy).max() < TOL[np.float32]
        assert abs(wa - ga) < TOL[np.float32]
    probs = rng.random((3, 4, E)).astype(np.float32)
    idx = rng.integers(0, E, (3, 4, K))
    want = ref_moe.router_aux_loss(jnp.asarray(probs), jnp.asarray(idx), E)
    got = moe.router_aux_loss(torch.from_numpy(probs), torch.from_numpy(idx),
                              E)
    assert abs(float(want) - float(got)) < TOL[np.float32]


def test_exact_router_ties_pick_the_reference_experts():
    """Experts 1, 2 and 5 have the same router column, so their
    probabilities tie exactly on every token: top-k takes the lower index
    first (`jax.lax.top_k`), and expert choice, order and output equal the
    reference's."""
    rng = np.random.default_rng(5)
    router, wg, wu, wd = _weights(rng)
    router[:, 2] = router[:, 5] = router[:, 1]
    router[:, 1] += 10.0 / D        # lift the tied trio to the top
    router[:, 2] = router[:, 5] = router[:, 1]
    x = np.abs(rng.normal(size=(4, 6, D))).astype(np.float32)
    ref_cfg, cfg = _configs()
    probs = jax.nn.softmax(jnp.einsum("btd,de->bte", jnp.asarray(x),
                                      jnp.asarray(router)), axis=-1)
    _, want_idx = jax.lax.top_k(probs, K)
    _, _, got_idx = moe.route(torch.from_numpy(x).reshape(1, 24, D),
                              torch.from_numpy(router), cfg)
    assert np.array_equal(np.asarray(want_idx).reshape(1, 24, K),
                          got_idx.numpy())
    assert (got_idx.numpy() == [1, 2]).all()        # ties, lower index first
    wy, _, gy, _ = _both(x, (router, wg, wu, wd), {}, True)
    assert np.abs(wy - gy).max() < TOL[np.float32]


def test_bf16_moe_ffn_matches_reference_without_near_ties():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 8, D)).astype(np.float32)
    weights = _weights(rng)
    # no near tie: every token's K-th and (K+1)-th expert lie apart by more
    # than any bf16 rounding of the router could move them
    _, cfg = _configs()
    probs, _, _ = moe.route(torch.from_numpy(x).to(torch.bfloat16)
                            .reshape(1, 32, D), torch.from_numpy(weights[0]),
                            cfg)
    top = torch.sort(probs, dim=-1, descending=True).values
    assert float((top[..., K - 1] - top[..., K]).min()) > 1e-3
    wy, wa, gy, ga = _both(x, weights, dict(n_groups=2), True, dt="bf16")
    assert np.abs(wy - gy).max() < TOL["bf16"]
    assert abs(wa - ga) < TOL[np.float32]


def test_routing_differences_tells_near_ties_from_faults():
    probs_a = torch.tensor([[0.4, 0.30, 0.1501, 0.1499],
                            [0.5, 0.30, 0.15, 0.05]])
    idx_a = torch.tensor([[0, 1, 2], [0, 1, 2]])
    # token 0: experts 2 and 3 swap on a 2e-4 gap moved by 3e-4: near tie;
    # token 1: expert 3 chosen over a 0.1 gap moved by 1e-4: a fault
    probs_b = probs_a + torch.tensor([[0.0, 0.0, -1.5e-4, 1.5e-4],
                                      [0.0, 0.0, 0.0, 1e-4]])
    idx_b = torch.tensor([[0, 1, 3], [0, 1, 3]])
    differs, gap, near = moe.routing_differences(probs_a, idx_a, probs_b,
                                                 idx_b)
    assert differs.tolist() == [True, True]
    assert near.tolist() == [True, False]
    assert abs(float(gap[1]) - 0.1) < 1e-6
    # the same set in another order is the same routing
    differs, _, _ = moe.routing_differences(probs_a, idx_a, probs_a,
                                            idx_a.flip(-1))
    assert not bool(differs.any())


def test_moe_transformer_config_builds():
    cfg = tfm.TransformerConfig(name="m", n_layers=2, d_model=32, n_heads=2,
                                n_kv_heads=1, d_ff=16, vocab=64,
                                moe=moe.MoEConfig(n_experts=4, top_k=2,
                                                  d_expert=16),
                                dtype=torch.float32)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layer = model.layers[0]
    assert layer.router.dtype == torch.float32
    assert tuple(layer.router.shape) == (32, 4)
    assert tuple(layer.wg.shape) == (4, 32, 16)
    assert tuple(layer.wd.shape) == (4, 16, 32)
    n = sum(p.numel() for p in model.parameters())
    # the model holds the padded vocabulary: count it unpadded
    assert n - (cfg.vocab_padded - cfg.vocab) * 32 * 2 == cfg.param_count()
    # two of four experts active: half the expert weights
    assert cfg.param_count() - cfg.active_param_count() == 2 * 3 * 2 * 32 * 16
    assert dataclasses.replace(cfg, moe=None).active_param_count() == \
        dataclasses.replace(cfg, moe=None).param_count()
    logits = tfm.forward(model, torch.zeros((1, 3), dtype=torch.long))
    assert logits.shape == (1, 3, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all())
