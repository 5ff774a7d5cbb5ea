"""Periodic BGK collide-stream of lbm_tpu_torch (CUDA kernel 1 and its plain
version) against lbm_tpu.

On the CPU the step takes the plain version, which is held to the Pallas
kernel in interpret mode (float32, the tolerances of tests/test_pallas.py)
and to the jnp oracle (float64, 1e-13).  The kernel itself is held to the
plain version on the card by tests/test_torch_cuda.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import bgk_pallas
from lbm_tpu.kernels import collide_stream as jcs
from lbm_tpu.ops import d2q9 as jd

from lbm_tpu_torch.kernels import _build, bgk, collide_stream
from lbm_tpu_torch.ops import d2q9 as td

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OMEGA = 1.0 / 0.8


def _state(R, C, seed=0):
    return np.random.default_rng(seed).uniform(0.05, 0.3, (9, R, C))


def _jax_oracle_step(f, omega):
    rho = jd.calc_rho(f)
    return jd.stream(jd.bgk_collision(f, jd.equilibrium(jd.calc_u(f, rho), rho),
                                      omega))


def test_plain_step_matches_pallas_kernel_f32():
    R, C = 32, 128
    f = _state(R, C).astype(np.float32)
    want = bgk_pallas.make_fused_step(R, C, OMEGA, jnp.float32, block_rows=8,
                                      interpret=True)(jnp.asarray(f))
    got = bgk.make_fused_step(R, C, OMEGA, torch.float32)(torch.as_tensor(f))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("shape", [(32, 128), (21, 21), (7, 5)])
def test_plain_step_matches_jnp_oracle_f64(shape):
    R, C = shape
    f = _state(R, C, seed=1)
    want = jnp.asarray(f)
    got = torch.as_tensor(f)
    step = bgk.make_fused_step(R, C, OMEGA, torch.float64)
    for _ in range(3):
        want = _jax_oracle_step(want, OMEGA)
        got = step(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)


def test_substeps_equal_repeated_single_steps():
    R, C = 16, 24
    f = torch.as_tensor(_state(R, C, seed=2))
    one = bgk.make_fused_step(R, C, OMEGA, torch.float64)
    four = bgk.make_fused_step(R, C, OMEGA, torch.float64, substeps=4)
    want = f
    for _ in range(4):
        want = one(want)
    assert torch.equal(four(f), want)


def test_pair_helpers_match_lbm_tpu():
    rng = np.random.default_rng(3)
    ux, uy = rng.uniform(-0.1, 0.1, (2, 6, 5))
    t0_t, pairs_t = collide_stream.d2q9_pairs(torch.as_tensor(ux), torch.as_tensor(uy))
    t0_j, pairs_j = jcs.d2q9_pairs(jnp.asarray(ux), jnp.asarray(uy))
    np.testing.assert_allclose(t0_t.numpy(), np.asarray(t0_j), rtol=0, atol=1e-15)
    assert collide_stream.PAIR_KS == jcs.PAIR_KS
    for pt, pj in zip(pairs_t, pairs_j):
        assert pt[:3] == pj[:3]
        for a, b in zip(pt[3:], pj[3:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-15)


def test_bgk_collide_fn_matches_ops():
    f = torch.as_tensor(_state(9, 11, seed=4))
    rho = td.calc_rho(f)
    want = td.bgk_collision(f, td.equilibrium(td.calc_u(f, rho), rho), OMEGA)
    got = bgk.bgk_collide_fn(OMEGA, torch.float64)(f)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-15)


def test_cpu_state_never_reaches_the_kernel():
    before = collide_stream.COLLIDE_STREAM_BGK.launches
    f = torch.as_tensor(_state(8, 8, seed=5))
    bgk.make_fused_step(8, 8, OMEGA, torch.float64, substeps=2)(f)
    assert collide_stream.COLLIDE_STREAM_BGK.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        collide_stream.collide_stream_bgk(f, OMEGA)


@pytest.mark.parametrize("bad", [
    dict(shape=(9, 8, 9), dtype=torch.float64),
    dict(shape=(9, 8, 8), dtype=torch.float32),
])
def test_step_rejects_other_states(bad):
    step = bgk.make_fused_step(8, 8, OMEGA, torch.float64)
    with pytest.raises(ValueError):
        step(torch.zeros(bad["shape"], dtype=bad["dtype"]))


@pytest.mark.parametrize("substeps", [0, 9])
def test_substeps_range(substeps):
    with pytest.raises(ValueError):
        bgk.make_fused_step(8, 8, OMEGA, torch.float64, substeps=substeps)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: writes the -o target, fails on a source named in $FAIL
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
for a in "$@"; do
  case "$a" in *.cu) echo "ptxas info    : Used 1 registers ($a)";
    [ -n "$FAIL" ] && case "$a" in *"$FAIL"*) echo "error in $a"; exit 1;; esac;;
  esac
done
: > "$out"
"""


@pytest.mark.parametrize("fail", ["", "channel_kbc"])
def test_build_compiles_each_source_then_links(monkeypatch, tmp_path, fail):
    """One compile per .cu file, then a link; a failing compile names its
    file, and no object file is left behind either way."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setenv("FAIL", fail)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if fail:
        with pytest.raises(RuntimeError, match="nvcc failed on channel_kbc.cu"):
            _build.build()
        assert not _build.library_path().exists()
    else:
        lib = _build.build()
        assert lib == _build.library_path() and lib.exists()
        log = lib.with_suffix(".log").read_text()
        for src in _build.CSRC.glob("*.cu"):
            assert f"== {src.name}" in log and f"({src})" in log
    assert not list((tmp_path / "build").glob("*.o"))


def test_package_data_lists_the_cuda_sources():
    """A wheel carries csrc/: pyproject.toml's package data for
    lbm_tpu_torch matches every source the build reads."""
    import fnmatch
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        globs = tomllib.load(fh)["tool"]["setuptools"]["package-data"]["lbm_tpu_torch"]
    assert {"csrc/*.cu", "csrc/*.cuh"} <= set(globs)
    sources = [f"csrc/{s.name}" for s in _build._sources()]
    assert len(sources) >= 20
    assert all(any(fnmatch.fnmatch(s, g) for g in globs) for s in sources)


def test_read_only_package_builds_into_the_user_cache(monkeypatch, tmp_path, caplog):
    """Where the package directory is not writable, the library is built
    into $XDG_CACHE_HOME/lbm_tpu_torch, and the build logs the directory."""
    assert _build._writable(tmp_path / "a" / "b")
    real_access = os.access
    ro = tmp_path / "site-packages"
    ro.mkdir()
    monkeypatch.setattr(_build.os, "access", lambda p, mode: (
        False if str(p).startswith(str(ro)) else real_access(p, mode)))
    monkeypatch.setattr(_build, "BUILD_DIR", ro / "lbm_tpu_torch" / "_build")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert not _build._writable(_build.BUILD_DIR)
    assert _build.build_dir() == tmp_path / "cache" / "lbm_tpu_torch"
    assert _build.library_path().parent == tmp_path / "cache" / "lbm_tpu_torch"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setenv("FAIL", "")
    with caplog.at_level("INFO", logger="lbm_tpu_torch"):
        lib = _build.build()
    assert lib.parent == tmp_path / "cache" / "lbm_tpu_torch" and lib.exists()
    assert f"building the CUDA kernels into {lib.parent}" in caplog.text
    assert not (ro / "lbm_tpu_torch").exists()
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.cache_dir() == tmp_path / "home" / ".cache" / "lbm_tpu_torch"


def test_library_path_is_keyed_by_sources():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR
    assert p.name.startswith("liblbm_kernels-") and p.suffix == ".so"
    assert p == _build.library_path()
    assert {s.name for s in _build._sources()} >= {
        "d2q9.cuh", "kbc.cuh", "collide_stream_bgk.cu", "channel_bgk.cu",
        "collide_stream_kbc.cu", "channel_kbc.cu", "collide_stream_les.cu"}


def test_failed_launch_raises_and_is_not_counted():
    kernel = _build.CudaKernel("test_symbol", [])
    kernel._fn = lambda *args: 9  # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        kernel.launch()
    assert kernel.launches == 0
    kernel._fn = lambda *args: 0
    kernel.launch()
    assert kernel.launches == 1
