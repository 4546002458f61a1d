"""The port's data-parallel training against the reference package, on the
CPU.

The counterparts of tests/test_dist.py's data-parallel tests and of
tests/test_checkpoint.py's restore with shardings.  The reference's
`quantize_int8` / `dequantize_int8` bit for bit on seeded leaves (an
all-zero leaf too); then one spawn of four gloo ranks (tests/torch_gloo.py)
runs every multi-rank check of this file: `make_sharded_train_step` on a
least-squares problem against the reference's single-device
`make_train_step` on the whole batch (1e-6), two int8 steps whose summed
gradients and residuals are held against the reference's per-rank
quantization of the same gradients and residuals, the int8 convergence of
tests/test_dist.py (150 steps, loss < 1e-2), and an elastic restore: a
tree whose rows were laid out 8 ways, saved whole, restored as the blocks
of a 2 x 4 layout, each equal to the slice of the reference's
`restore_pytree` of the same checkpoint.  Without a process group the
data-parallel step is the one-device step, bit for bit.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_pytree as ref_restore  # noqa: E402
from repro.dist import collectives as ref_coll  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_loop as ref_loop  # noqa: E402
from repro_torch.checkpoint import restore_pytree, save_pytree  # noqa: E402
from repro_torch.dist import collectives, sharding  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402
from torch_gloo import run_ranks  # noqa: E402

WORLD = 4
DP_TOL = 1e-6          # tests/test_dist.py's sharded-vs-single limit
LSQ = dict(lr=5e-2, weight_decay=0.0, warmup_steps=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lsq_problem(seed=0, rows=32):
    """tests/test_dist.py's least-squares problem from numpy seeds: x [rows,
    4], y = x @ w_true; parameters w [4, 1] (ones) and b [1] (zeros)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 4)).astype(np.float32)
    w_true = rng.normal(size=(4, 1)).astype(np.float32)
    params = {"w": np.ones((4, 1), np.float32), "b": np.zeros((1,), np.float32)}
    return params, {"x": x, "y": (x @ w_true).astype(np.float32)}


def _ref_lsq_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2), {}


def _lsq_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2), {}


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def _leaves():
    rng = np.random.default_rng(7)
    return {"normal": rng.normal(size=(33, 17)).astype(np.float32),
            "wide": (rng.normal(size=(1000,)) * 1e4).astype(np.float32),
            "tiny": (rng.normal(size=(5, 5)) * 1e-30).astype(np.float32),
            "halves": (np.arange(-254, 255, dtype=np.float32) / 2.0),
            "zero": np.zeros((6, 3), np.float32),
            "scalar": np.array(-3.25, np.float32)}


@pytest.mark.parametrize("leaf", sorted(_leaves()))
def test_quantize_int8_bit_equal_to_reference(leaf):
    """q, scale and the dequantized values equal the reference's bit for
    bit (round half to even; an all-zero leaf has scale 0)."""
    x = _leaves()[leaf]
    rq, rs = ref_coll.quantize_int8(jnp.asarray(x))
    q, s = collectives.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs, np.float32).tobytes()
    rd = np.asarray(ref_coll.dequantize_int8(rq, rs))
    assert collectives.dequantize_int8(q, s).numpy().tobytes() == rd.tobytes()
    if leaf == "zero":
        assert float(s) == 0.0 and not q.any()


def test_one_rank_dp_step_is_the_one_device_step():
    """Without a process group, make_sharded_train_step is make_train_step
    bit for bit (float32 sums over one rank, divided by 1), and its int8
    variant carries the quantization error in the residual."""
    params, batch = _lsq_problem()
    cfg = opt.OptimizerConfig(**LSQ)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p1 = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    p2 = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    s1, s2 = opt.init_state(cfg, p1), opt.init_state(cfg, p2)
    mesh = make_host_mesh(device="cpu")
    sstep = train_loop.make_sharded_train_step(_lsq_loss, cfg, mesh)
    step = train_loop.make_train_step(_lsq_loss, cfg)
    res = train_loop.init_residual(p1)
    for _ in range(3):
        p1, s1, res, m1 = sstep(p1, s1, res, tb)
        p2, s2, m2 = step(p2, s2, tb)
        assert torch.equal(m1["loss"], m2["loss"])
        for k in p1:
            assert torch.equal(p1[k], p2[k]), k
    assert all(not r.any() for r in res.values())
    qstep = train_loop.make_sharded_train_step(_lsq_loss, cfg, mesh,
                                               compression="int8")
    p3 = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    _, _, res, _ = qstep(p3, opt.init_state(cfg, p3),
                         train_loop.init_residual(p3), tb)
    assert any(r.any() for r in res.values())
    with pytest.raises(ValueError, match="compression"):
        train_loop.make_sharded_train_step(_lsq_loss, cfg, mesh,
                                           compression="fp8")


def test_dp_gradients_reduce_in_place_and_copy_what_they_share():
    """The dp step reduces autograd's gradients in place; a gradient that
    shares its storage with another leaf's, is a strided view or is not
    float32 is copied first, so no leaf is divided twice and a shared
    tensor is left as it is.  Without a process group the sum is the
    identity."""
    own = torch.full((3,), 4.0)
    shared = torch.full((2, 2), 8.0)
    view = torch.arange(6.0).reshape(2, 3).t()
    half = torch.full((2,), 2.0, dtype=torch.bfloat16)
    got = train_loop._reduce_mean_(
        {"own": own, "a": shared, "b": shared, "view": view, "half": half},
        None, 2)
    assert got["own"] is own and torch.equal(own, torch.full((3,), 2.0))
    assert torch.equal(got["a"], torch.full((2, 2), 4.0))
    assert torch.equal(got["b"], torch.full((2, 2), 4.0))
    assert torch.equal(shared, torch.full((2, 2), 8.0))
    assert torch.equal(got["view"], torch.arange(6.0).reshape(2, 3).t() / 2)
    assert got["half"].dtype == torch.float32
    assert torch.equal(got["half"], torch.ones(2))


def test_dp_batch_must_divide():
    batch = {"x": torch.zeros(10, 4)}
    assert sharding.split_rows(batch, 1, 2)["x"].shape == (5, 4)
    with pytest.raises(ValueError, match="do not split"):
        sharding.split_rows(batch, 0, 4)


def test_placement_follows_the_reference_shard_rule():
    """A dimension splits only when it divides the axis (the reference's
    `_shard_dim`), else the leaf is replicated; blocks are contiguous."""
    t = torch.arange(48.0).reshape(8, 6)
    p = sharding.placement(t.shape, 0, 3, 4, "cpu")
    assert (p.dim, p.index, p.count) == (0, 3, 4)
    assert torch.equal(p.block(t), t[6:8])
    assert torch.equal(sharding.placement(t.shape, 1, 1, 3, "cpu").block(t),
                       t[:, 2:4])
    for dim, n in ((1, 4), (2, 2), (0, 16)):
        rep = sharding.placement(t.shape, dim, 1, n, "cpu")
        assert rep.dim is None and torch.equal(rep.block(t), t)


def test_restore_with_single_device_placements(tmp_path):
    """tests/test_checkpoint.py::test_elastic_restore_with_shardings: a
    tree of one-block placements restores every leaf whole, the others
    (None) on the given device."""
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "n": {"b": torch.arange(5, dtype=torch.int32),
                  "c": [torch.ones(2, 2)]}}
    save_pytree(str(tmp_path / "ck"), tree)
    sh = {"a": sharding.placement((3, 4), 0, 0, 1, "cpu"),
          "n": {"b": None, "c": [sharding.placement((2, 2), 1, 0, 1, "cpu")]}}
    got = restore_pytree(str(tmp_path / "ck"), tree, shardings=sh)
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["n"]["b"], tree["n"]["b"])
    assert torch.equal(got["n"]["c"][0], tree["n"]["c"][0])


# ---------------------------------------------------------------------------
# four gloo ranks, one spawn
# ---------------------------------------------------------------------------

_RANKS = """
from repro_torch.checkpoint import CheckpointManager
from repro_torch.dist import collectives, sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop

mesh = make_host_mesh(device="cpu")
assert mesh.dp_size == world and mesh.dp_rank == rank


def loss_fn(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def fresh(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


out = {}
cfg = opt.OptimizerConfig(**inputs["lsq_cfg"])
batch = fresh(inputs["batch"])

# the float32 data-parallel step
params = fresh(inputs["params"])
step = train_loop.make_sharded_train_step(loss_fn, cfg, mesh)
params, state, _, m = step(params, opt.init_state(cfg, params),
                           train_loop.init_residual(params), batch)
out["dp"] = {"params": {k: v.detach().numpy() for k, v in params.items()},
             "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}

# two int8 steps, each compressed sum recorded
calls = []
inner = train_loop.compressed_psum_with_feedback


def recording(grads, residual, group):
    summed, res = inner(grads, residual, group)
    calls.append({k: (grads[k].numpy().copy(), residual[k].numpy().copy(),
                      summed[k].numpy().copy(), res[k].numpy().copy())
                  for k in grads})
    return summed, res


train_loop.compressed_psum_with_feedback = recording
params = fresh(inputs["params"])
qstep = train_loop.make_sharded_train_step(loss_fn, cfg, mesh,
                                           compression="int8")
state, res = opt.init_state(cfg, params), train_loop.init_residual(params)
for _ in range(2):
    params, state, res, m = qstep(params, state, res, batch)
train_loop.compressed_psum_with_feedback = inner
out["int8_calls"] = calls

# tests/test_dist.py's convergence under int8: 150 steps
conv = inputs["conv"]
params = fresh(conv["params"])
cbatch = fresh(conv["batch"])
ccfg = opt.OptimizerConfig(**inputs["lsq_cfg"])
qstep = train_loop.make_sharded_train_step(loss_fn, ccfg, mesh,
                                           compression="int8")
state, res = opt.init_state(ccfg, params), train_loop.init_residual(params)
for _ in range(150):
    params, state, res, m = qstep(params, state, res, cbatch)
out["conv_loss"] = float(m["loss"])

# elastic restore: rows laid out 8 ways (two blocks a rank), gathered and
# saved whole by rank 0, then each rank restores two positions of a
# 2 (data) x 4 (model) layout
whole = fresh(inputs["tree"])
whole["opt"] = {"m": whole.pop("m"), "step": whole.pop("step")}
mine = [sharding.placement(whole["w"].shape, 0, 2 * rank + j, 8, "cpu")
        for j in range(2)]
blocks = torch.cat([p.block(whole["w"]) for p in mine])
parts = [torch.empty_like(blocks) for _ in range(world)]
dist.all_gather(parts, blocks)
saved = dict(whole, w=torch.cat(parts))
mgr = CheckpointManager(os.path.join(tmp, "ck"), keep=2)
if rank == 0:
    mgr.save(3, saved)
dist.barrier()
like = {k: (torch.zeros_like(v) if k != "opt" else
            {kk: torch.zeros_like(vv) for kk, vv in v.items()})
        for k, v in whole.items()}
out["restored"] = []
for j in range(2):
    pos = 2 * rank + j
    data, model = pos // 4, pos % 4
    sh = {"w": sharding.placement(whole["w"].shape, 0, model, 4, "cpu"),
          "v": sharding.placement(whole["v"].shape, 0, model, 4, "cpu"),
          "opt": {"m": sharding.placement(whole["opt"]["m"].shape, 0, data,
                                          2, "cpu"),
                  "step": None}}
    got_step, got = mgr.restore_latest(like, shardings=sh)
    out["restored"].append({
        "data": data, "model": model, "step": got_step,
        "dims": {"w": sh["w"].dim, "v": sh["v"].dim, "m": sh["opt"]["m"].dim},
        "w": got["w"].numpy(), "v": got["v"].numpy(),
        "m": got["opt"]["m"].numpy(), "opt_step": got["opt"]["step"].numpy()})
out["ckpt"] = os.path.join(tmp, "ck", "step_00000003")
dump(out)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params, batch = _lsq_problem(seed=0, rows=32)
    cparams, cbatch = _lsq_problem(seed=1, rows=64)
    cparams = {k: np.zeros_like(v) for k, v in cparams.items()}
    rng = np.random.default_rng(3)
    inputs = {"lsq_cfg": LSQ, "params": params, "batch": batch,
              "conv": {"params": cparams, "batch": cbatch},
              "tree": {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
                       "v": rng.normal(size=(6, 4)).astype(np.float32),
                       "m": rng.normal(size=(8,)).astype(np.float32),
                       "step": np.array(3, np.int32)}}
    got = run_ranks(_RANKS, inputs, tmp_path_factory.mktemp("dp"), WORLD)
    return inputs, got


def test_dp_step_matches_reference_single_device(ranks):
    """Four ranks, each on 8 of the 32 rows: the new parameters equal the
    reference's single-device step on all 32 rows to 1e-6 (as
    tests/test_dist.py holds them), its loss and grad norm (~10, the mean
    of four block means against one mean) to 1e-6 of their value, and
    every rank holds the same parameters."""
    inputs, got = ranks
    cfg = ref_opt.OptimizerConfig(**LSQ)
    jp = {k: jnp.asarray(v) for k, v in inputs["params"].items()}
    jb = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    step = ref_loop.make_train_step(_ref_lsq_loss, cfg, donate=False)
    jp2, _, jm = step(jp, ref_opt.init_state(cfg, jp), jb)
    for r in got:
        for k in jp2:
            err = float(np.abs(np.asarray(jp2[k]) - r["dp"]["params"][k]).max())
            assert err < DP_TOL, (k, err)
            np.testing.assert_array_equal(r["dp"]["params"][k],
                                          got[0]["dp"]["params"][k])
        for k in ("loss", "grad_norm"):       # ~10: 1e-6 of the value
            want = float(jm[k])
            assert abs(want - r["dp"][k]) < DP_TOL * abs(want), (k, want)


def test_int8_step_sums_reference_dequantized_values(ranks):
    """Each of two int8 steps: every rank's new residual is the
    reference's x - dequantize(quantize(x)) of x = its gradient plus its
    residual (bit for bit), its summed gradient is the sum over ranks of
    the reference's dequantized x (float32, summed in another order: 4
    ulps of the sum's scale), the same on every rank; the second step's
    residuals are nonzero."""
    _, got = ranks
    assert all(len(r["int8_calls"]) == 2 for r in got)
    for s in range(2):
        for k in got[0]["int8_calls"][s]:
            deqs = []
            for r in got:
                g, res_in, summed, res_out = r["int8_calls"][s][k]
                x = jnp.asarray(g).astype(jnp.float32) + jnp.asarray(res_in)
                q, scale = ref_coll.quantize_int8(x)
                deq = ref_coll.dequantize_int8(q, scale)
                want_res = np.asarray(x - deq, np.float32)
                assert res_out.tobytes() == want_res.tobytes(), (s, k)
                deqs.append(np.asarray(deq, np.float32))
                np.testing.assert_array_equal(summed,
                                              got[0]["int8_calls"][s][k][2])
            want = np.sum(np.stack(deqs).astype(np.float64), axis=0)
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(summed - want).max())
            assert err <= 4 * np.finfo(np.float32).eps * scale, (s, k, err)
    assert any(np.abs(r["int8_calls"][1][k][1]).max() > 0
               for r in got for k in r["int8_calls"][1])


def test_int8_dp_training_converges(ranks):
    """tests/test_dist.py::test_compressed_dp_training_converges on four
    gloo ranks: the all-reduced loss after 150 int8 steps < 1e-2, the same
    on every rank."""
    _, got = ranks
    assert got[0]["conv_loss"] < 1e-2, got[0]["conv_loss"]
    assert len({r["conv_loss"] for r in got}) == 1


def test_elastic_restore_8_way_rows_to_2x4(ranks):
    """tests/test_dist.py::test_elastic_resume_across_mesh_shapes: each
    block restored in the 2 x 4 layout equals the slice of the reference's
    `restore_pytree` of the same checkpoint (the port's files read by the
    reference), exactly; `v` (6 rows on 4 blocks) is replicated, as the
    reference's `_shard_dim` leaves it."""
    inputs, got = ranks
    t = inputs["tree"]
    like = {"w": jnp.zeros((8, 8), jnp.float32),
            "v": jnp.zeros((6, 4), jnp.float32),
            "opt": {"m": jnp.zeros((8,), jnp.float32),
                    "step": jnp.zeros((), jnp.int32)}}
    ref = ref_restore(got[0]["ckpt"], like)
    np.testing.assert_array_equal(np.asarray(ref["w"]), t["w"])
    positions = sorted((b["data"], b["model"]) for r in got
                       for b in r["restored"])
    assert positions == [(d, m) for d in range(2) for m in range(4)]
    for r in got:
        for b in r["restored"]:
            d, m = b["data"], b["model"]
            assert b["step"] == 3
            assert b["dims"] == {"w": 0, "v": None, "m": 0}
            np.testing.assert_array_equal(b["w"],
                                          np.asarray(ref["w"])[2 * m:2 * m + 2])
            np.testing.assert_array_equal(b["v"], np.asarray(ref["v"]))
            np.testing.assert_array_equal(
                b["m"], np.asarray(ref["opt"]["m"])[4 * d:4 * d + 4])
            np.testing.assert_array_equal(b["opt_step"],
                                          np.asarray(ref["opt"]["step"]))
