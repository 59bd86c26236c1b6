"""What the program reads from the device it runs on: published peak
rates, memory budgets, the compile cache's place, the device count a
multi-device run needs — and chip_smoke.py's phases, run here on a
one-device CPU mesh at the yeast rung's scale."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

import chip_smoke
from gnnpe_tpu.index import device_packed
from gnnpe_tpu.parallel.mesh import make_mesh
from gnnpe_tpu.utils import compile_cache, device_probe

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kind,want", [
    ("NVIDIA H100 80GB HBM3", (3.35e12, 989e12)),
    ("NVIDIA H200", (4.8e12, 989e12)),
    ("Unlisted Accelerator 9000", None),
])
def test_peak_rates_table(kind, want):
    if want is None:
        with pytest.raises(KeyError, match="no published peaks"):
            device_probe.peak_rates(kind)
    else:
        assert device_probe.peak_rates(kind) == want


def test_device_constants_row_cost_from_bandwidth():
    bw, flops, row_s = device_probe.device_constants(feature_dim=64)
    assert (bw, flops) == device_probe.PEAKS["cpu"]
    assert row_s == 4 * 64 / bw


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("env,stats,want", [
    (None, {"bytes_limit": 60_000_000_000}, 60e9),
    ("16e9", {"bytes_limit": 60_000_000_000}, 16e9),
    (None, None, RuntimeError),
])
def test_memory_budget_source(monkeypatch, env, stats, want):
    """GNNPE_HBM_BYTES overrides; else the device's bytes_limit; a
    device with neither raises instead of assuming a size."""
    import jax
    if env is None:
        monkeypatch.delenv("GNNPE_HBM_BYTES", raising=False)
    else:
        monkeypatch.setenv("GNNPE_HBM_BYTES", env)
    monkeypatch.delenv("GNNPE_CACHE_BYTES", raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(stats)])
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="GNNPE_HBM_BYTES"):
            device_packed.hbm_budget_bytes()
        return
    assert device_packed.device_memory_bytes() == want
    assert device_packed.hbm_budget_bytes() == 0.35 * want
    assert device_packed.cache_budget_bytes() == 0.55 * want


def test_compile_cache_env_wins_over_path(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir("/elsewhere") == str(tmp_path)
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == str(REPO / ".cache" / "jax")
    assert compile_cache.cache_dir("/x") == "/x"


def test_dryrun_multichip_refuses_missing_devices():
    import jax
    import __graft_entry__ as ge
    with pytest.raises(RuntimeError, match="needs"):
        ge.dryrun_multichip(len(jax.devices()) + 1)


# ---------------------------------------------------------------------
# chip_smoke.py: phase functions on the CPU, main() refusing the CPU.

def test_chip_smoke_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert "no GPU found" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repo, the script cannot import the program and
    must fail without printing a result."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def yeast():
    from gnnpe_tpu.io.datasets import load_dataset
    g = load_dataset("yeast")
    return g, chip_smoke.sample_queries(g, n=4)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1, axes=("graph",), shape=(1,))


def test_chip_smoke_pe_phases(yeast, mesh1, capsys):
    g, qs = yeast
    eng = chip_smoke.pe_build(g, mesh1, block_size=64)
    assert not eng.sharded.streamed
    out = chip_smoke.pe_serve(eng, qs)
    eng.sharded.close()
    assert len(out["answers"]) == len(qs)
    printed = capsys.readouterr().out
    assert "build_phase_ms=" in printed and "spot_checked=[0, " in printed


def test_chip_smoke_pge_phase(yeast, mesh1):
    g, qs = yeast
    out = chip_smoke.pge_phase(g, mesh1, qs)
    assert min(out["answers"]) >= 1     # walked queries always match


def test_chip_smoke_streamed_phase_evicts(yeast, mesh1):
    g, _ = yeast
    out = chip_smoke.streamed_phase(g, mesh1,
                                    chip_smoke.sample_queries(g, n=16))
    assert out["misses"] > 0 and out["hits"] > 0


def test_chip_smoke_spmm_phase():
    out = chip_smoke.spmm_phase(num_vertices=2000, num_edges=16000,
                                dim=32, reps=2)
    assert set(out) >= {"segment_sum", "binned_ell"}
    hub = [k for k in out if k.startswith("binned_ell_hub")]
    assert len(hub) == 1 and out[hub[0]]["max_rel_err"] < 1e-4


def test_chip_smoke_result_line(monkeypatch, capsys):
    """main() with every phase stubbed: the last stdout line is the
    contract's JSON object, and --four-cards runs no yeast/SpMM phase."""
    ran = []
    dev = dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=4)
    monkeypatch.setattr(chip_smoke, "device_phase",
                        lambda count: dict(dev, count=count))
    monkeypatch.setattr(chip_smoke, "nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    from __graft_entry__ import _toy_graph
    monkeypatch.setattr(chip_smoke, "load_dataset",
                        lambda name, seed=0: ran.append(name)
                        or _toy_graph())
    monkeypatch.setattr(chip_smoke, "sample_queries", lambda g, n=8: [])

    class _Eng:
        class sharded:
            close = staticmethod(lambda: None)
    for name in ("pe_serve", "pge_phase", "streamed_phase", "spmm_phase"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, **k: ran.append(_n))
    monkeypatch.setattr(chip_smoke, "pe_build", lambda *a, **k: _Eng())
    assert chip_smoke.main(["--four-cards"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": dev}
    assert ran == ["dblp", "pe_serve", "pge_phase"]
