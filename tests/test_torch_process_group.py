"""The port's gatherv/scatterv over ``ProcessGroupMesh``: one rank per
process, exchanges through ``torch.distributed`` (gloo on the CPU).

The test runs this file as a script in a subprocess with a hard timeout;
the script spawns 8 ranks that meet through a file store under the
test's own ``tmp_path`` (so parallel test workers never share a port) and
sweep every distribution × roots {0, 3, 7} × bucket {1, 3} × segments
{1, 4}, holding every result bitwise against ``np.concatenate`` and the
input blocks.  Rank 0 prints the line the test looks for.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 8
TIMEOUT_S = 300


def _worker(rank: int, init_file: str) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    import repro_torch as rt
    from repro_torch.core.distributions import NAMES, block_sizes

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        mesh = rt.ProcessGroupMesh(device="cpu")
        assert mesh.ranks == (rank,) and mesh.p == WORLD
        n = 0
        for name in NAMES:
            # every rank makes the same blocks from the seed; each reads
            # only its own, and the root checks the gathered result
            rng = np.random.default_rng(len(name))
            blocks = [rng.standard_normal((s, 4)).astype(np.float32)
                      for s in block_sizes(name, WORLD, 7, seed=1)]
            sizes = [len(b) for b in blocks]
            want = np.concatenate(blocks)
            for root in (0, 3, 7):
                for bucket_rounds in (1, 3):
                    for segments in (1, 4):
                        kw = dict(bucket_rounds=bucket_rounds,
                                  segments=segments)
                        got, _ = rt.run_gatherv(mesh, blocks, root, **kw)
                        if rank == root:
                            np.testing.assert_array_equal(got, want)
                        else:
                            assert got is None
                        outs, _ = rt.run_scatterv(mesh, want, sizes, root,
                                                  **kw)
                        np.testing.assert_array_equal(outs[rank],
                                                      blocks[rank])
                        assert all(o is None for r, o in enumerate(outs)
                                   if r != rank)
                        n += 1
        dist.barrier()
        if rank == 0:
            print(f"{n} cases x {WORLD} ranks: PROCESS GROUP LANE PASSED",
                  flush=True)
    finally:
        dist.destroy_process_group()


def test_process_group_mesh_gloo_lane(child_env, tmp_path):
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp_path / "pg")],
        env=child_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the launcher and its ranks
        out, err = proc.communicate()
        pytest.fail(f"gloo lane hung past {TIMEOUT_S} s\n{out}\n{err}")
    assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    assert "PROCESS GROUP LANE PASSED" in out


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.start_processes(_worker, args=(sys.argv[1],), nprocs=WORLD,
                       start_method="spawn")
