"""The port's drivers (``repro_torch.examples``, ``repro_torch.benchmarks.
other_problems`` and ``pt_compare``) run on the CPU and print what the JAX
package's do; their numbers equal the port's entry points."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import other_problems, pt_compare  # noqa: E402
from repro_torch.core import gset  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.pt import PTHyperParams, anneal_pt  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams, anneal  # noqa: E402
from repro_torch.examples import anneal_gset, expert_placement  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run cycle loops of tiny tensors: one intra-op thread is
    faster for them and keeps six test workers from oversubscribing the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_anneal_gset_prints_hassa_and_sa_columns(capsys):
    anneal_gset.main(["--problems", "G11", "--backend", "dense", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "HA-SSA: best" in out and "SA    : best" in out


def test_anneal_gset_stream_demo(capsys):
    anneal_gset.main(["--stream-demo", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("status=ok") == 5 and "stream drained in" in out


def test_expert_placement_example(capsys):
    expert_placement.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "improvement" in out and "assignment (expert -> device)" in out


def test_other_problems_smoke_passes(capsys, tmp_path):
    rep = other_problems.run(smoke=True, device="cpu", json_path=str(tmp_path / "p.json"))
    assert rep["ok"], rep["failures"]
    assert set(rep["families"]) == {"qubo", "mis", "coloring", "partition"}
    assert all(row["backends_agree"] for row in rep["families"].values())
    assert (tmp_path / "p.json").exists()


def test_pt_compare_table7_rows(capsys):
    got = pt_compare.run("G11", trials=4, m_shot=2, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert [line.split(",")[0] for line in out] == [
        "table7_pt/G11/hassa", "table7_pt/G11/pt", "table7_pt/G11/hassa_vs_pt_cut"]
    hp = SSAHyperParams(n_trials=4, m_shot=2)
    ha = anneal(gset.load("G11"), hp, seed=0, track_energy=False, config=SolverConfig(),
                device="cpu")
    pt = anneal_pt(gset.load("G11"), PTHyperParams(n_replicas=8, n_cycles=hp.total_cycles),
                   seed=0, track_energy=False, device="cpu")
    np.testing.assert_array_equal(got["ha"].best_m, ha.best_m)
    assert got["pt"].best_cut == pt.best_cut
