"""Multi-process jax.distributed exercise (SURVEY.md §4.5a/§5.8): two REAL processes join via launch.init_distributed
(coordinator + HAN_* env resolution), form one 4-device global mesh
(2 local CPU devices each), and run edge-partitioned attention across the
process boundary — gloo CPU collectives stand in for the device
interconnect. Equality with the single-process result is asserted inside
each worker."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHILD = os.path.join(_ROOT, "tests", "mp_partitioned_child.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_partitioned_attention():
    port = str(_free_port())
    env = dict(os.environ)
    # children pick their own platform/device-count; scrub pytest's flags
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, _CHILD, str(pid), port],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env, cwd=_ROOT)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=360)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "MP_OK" in out, f"proc {pid} no MP_OK:\n{out[-3000:]}"


def _spawn_pair(child, port, env, extra):
    return [
        subprocess.Popen([sys.executable, child, str(pid), port, *extra],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env, cwd=_ROOT)
        for pid in range(2)
    ]


def test_kill_a_host_elastic_recovery(tmp_path):
    """Fault injection (SURVEY.md §5.3): kill worker 1 mid-run; the
    surviving worker stalls on the next collective and is torn down; both
    workers RESTART and resume from the coordinator's checkpoint,
    finishing with exactly the trajectory of an uninterrupted run."""
    child = os.path.join(_ROOT, "tests", "mp_killhost_child.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    steps = "8"

    def read_final(out):
        for line in out.splitlines():
            if line.startswith("FINAL"):
                return float(line.split()[1])
        raise AssertionError(f"no FINAL in:\n{out[-2000:]}")

    # uninterrupted reference run
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    procs = _spawn_pair(child, str(_free_port()), env, [str(ref_dir), steps])
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][-2000:]
    ref_final = read_final(outs[0])

    # faulted run: kill worker 1 after it reports step 2
    kill_dir = tmp_path / "kill"
    kill_dir.mkdir()
    procs = _spawn_pair(child, str(_free_port()), env, [str(kill_dir), steps])
    seen = 0
    import time as _t
    deadline = _t.time() + 240
    while _t.time() < deadline and seen < 3:
        line = procs[1].stdout.readline()
        if line.startswith("STEP"):
            seen += 1
    assert seen >= 3, "worker 1 never progressed"
    procs[1].kill()                      # ← the dead host
    # worker 0 now hangs on the next collective → detect + tear down
    try:
        procs[0].communicate(timeout=20)
        # (it may also exit with a distributed error — both are fine)
    except subprocess.TimeoutExpired:
        procs[0].kill()
        procs[0].communicate()

    # elastic recovery: relaunch BOTH workers; they resume from the last
    # step_<i>.npz and must reach the uninterrupted final loss exactly
    assert any(kill_dir.glob("step_*.npz")), "no checkpoint was written"
    procs = _spawn_pair(child, str(_free_port()), env, [str(kill_dir), steps])
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][-2000:]
    # resumed run skipped the already-done steps
    first_steps = [int(l.split()[1]) for l in outs[0].splitlines()
                   if l.startswith("STEP")]
    assert first_steps and first_steps[0] >= 3
    np.testing.assert_allclose(read_final(outs[0]), ref_final, rtol=1e-6)
