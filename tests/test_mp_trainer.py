"""The full-graph Trainer across two real processes (jax.distributed, a
4-device graph mesh over 2 CPU devices each) with checkpoints in a shared
directory: only the coordinator writes, every process resumes from the
same step, and a resumed run repeats the uninterrupted trajectory."""

import os
import socket
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHILD = os.path.join(_ROOT, "tests", "mp_trainer_child.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_trainer_checkpoint_resume(tmp_path):
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, _CHILD, str(pid), port, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=_ROOT) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "MPT_OK" in out, \
            f"proc {pid} failed:\n{out[-3000:]}"
    assert not any(n.startswith(".tmp") for d in tmp_path.iterdir()
                   for n in os.listdir(next(d.iterdir())))
