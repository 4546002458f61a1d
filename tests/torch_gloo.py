"""Gloo ranks on the CPU for the port's multi-rank tests.

`run_ranks(body, inputs, tmp_path)` writes `inputs` to a pickle, runs
`body` (Python source) in `world` processes that each join one gloo
process group, and returns what each rank passed to `dump(obj)`, in rank
order.  In `body`, `rank`, `world` and `tmp` name the process's rank, the
world size and the scratch directory, `inputs` holds the unpickled
inputs, and `torch`, `dist` (torch.distributed), `np` and `pickle` are
imported; the port's `src/` is on the path.  Each rank runs one torch
thread: the ranks share the host's cores.
"""
import os
import pickle
import subprocess
import sys
import textwrap

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import os, pickle, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", world_size=world, rank=rank,
                        init_method="file://" + os.path.join(tmp, "store"))
with open(os.path.join(tmp, "inputs.pkl"), "rb") as fh:
    inputs = pickle.load(fh)


def dump(obj):
    with open(os.path.join(tmp, f"rank{{rank}}.pkl"), "wb") as fh:
        pickle.dump(obj, fh)


"""

_CODA = """
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(body: str, inputs, tmp_path, world: int = 4,
              timeout: float = 240) -> list:
    with open(tmp_path / "inputs.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    script = tmp_path / "rank.py"
    script.write_text(_PRELUDE.format(src=os.path.join(_ROOT, "src"))
                      + textwrap.dedent(body) + _CODA)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(world), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    got = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as fh:
            got.append(pickle.load(fh))
    return got
