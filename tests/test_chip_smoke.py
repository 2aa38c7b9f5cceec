"""chip_smoke.py off the card: it refuses to run without a GPU or outside
the repo, its graph builder gives the DBLP shapes at a reduced size, and
its phases and comparison gates work at tiny sizes on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_exits_nonzero_without_a_gpu():
    out = _run(_ROOT, "chip_smoke.py")
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr and "cpu" in out.stderr
    assert not _has_result(out.stdout)


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0 and not _has_result(out.stdout)


def test_graph_builder_shapes_at_reduced_size():
    """406 authors (a tenth): DBLP's features, classes, split proportions
    and meta-path densities (APA ≈ 2.7 per author, APCPA ≈ 30%,
    APTPA ≈ 78% of all pairs, self-loops counted)."""
    ds = chip_smoke.graph_phase(seed=1, n_nodes=406)
    n = ds.n_nodes
    assert n == 406 and ds.features.shape == (406, 334) and ds.n_classes == 4
    assert ds.metapath_names == ("APA", "APCPA", "APTPA")
    assert (ds.train_mask.sum(), ds.val_mask.sum()) == (80, 40)
    assert not (ds.train_mask & ds.val_mask).any()
    assert (ds.train_mask | ds.val_mask | ds.test_mask).all()
    assert set(np.unique(ds.features)) <= {0.0, 1.0}
    edges = [a.nnz + n for a in ds.metapath_adjs]
    assert 2.2 * n < edges[0] < 3.3 * n
    assert 0.25 < edges[1] / n**2 < 0.36
    assert 0.72 < edges[2] / n**2 < 0.84
    for a in ds.metapath_adjs:
        assert (a != a.T).nnz == 0 and a.diagonal().sum() == 0


def test_parity_phases_at_tiny_size():
    ds = chip_smoke.graph_phase(seed=2, n_nodes=120)
    chip_smoke.op_parity_phase(ds, seed=2, k=4, d=4)
    chip_smoke.forward_parity_phase(ds, seed=2)


def test_comparison_gate_can_fail():
    ref = np.linspace(-1.0, 1.0, 50)
    chip_smoke.check_close("same", ref + 1e-7, ref, rtol=1e-4, atol=1e-5)
    with pytest.raises(AssertionError, match="outside tolerance"):
        chip_smoke.check_close("off", ref * 1.01, ref, rtol=1e-4, atol=1e-5)
    with pytest.raises(AssertionError, match="outside tolerance"):
        chip_smoke.check_scaled("off", ref + 0.05, ref, tol=2e-2)


def test_multi_card_phases_on_cpu_mesh(tmp_path):
    ds = chip_smoke.graph_phase(seed=3, n_nodes=160)
    chip_smoke.partitioned_phase(ds, seed=3, epochs=2, cards=4, out_dir=tmp_path)
    chip_smoke.dp_sampled_phase(3, 4, tmp_path, n_nodes=3000, epochs=2,
                                batch_size=32, n_batches=3)
