"""chip_smoke.py's phases at tiny widths on the CPU backend, its refusal to
run off the GPU, and the device-plane rules it relies on: the compile-cache
placement and ``engine="auto"`` failing loudly instead of falling back."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
import nvorbis_tpu as nv
from nvorbis_tpu.testgen import corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_the_cpu_backend(argv, capsys):
    assert cs.main(argv) != 0
    out = capsys.readouterr()
    assert out.out == ""  # no result line
    assert "needs the GPU" in out.err


@pytest.mark.parametrize("n", [256, 2048, 8192])
def test_phase_synth_matches_oracle(n):
    res = cs.phase_synth(ns=(n,), batch=4)[n]
    assert res["err"] <= cs.SYNTH_BOUND
    assert res["platforms"] == {"cpu"}


def test_phase_sym_ola_bit_identical():
    assert cs.phase_sym_ola() == {"ulp_sym": 0, "ulp_ola": 0}


def test_phase_reader_small():
    res = cs.phase_reader(names=(corpus.MONO_SHORT, corpus.STEREO))
    assert set(res[corpus.STEREO]) == {"read_all", "seek", "forward_only"}
    assert "seek" not in res[corpus.MONO_SHORT]  # 0.4 s: nothing at 3 s


def test_phase_batch_small():
    res = cs.phase_batch(repeats=1, streams=2, s51_streams=1,
                         s51_packets=64)
    assert res["longform"]["err"] <= cs.BATCH_BOUND
    assert res["longform"]["audio_s"] > 0


def test_phase_short_small():
    res = cs.phase_short(reps=1, long_repeats=(2,))
    assert len(res["rows"]["jax"]) == len(res["rows"]["host"]) == 3
    assert res["device_short_s"] > 0 and res["host_short_s"] > 0


def test_phase_multi_on_virtual_devices():
    res = cs.phase_multi(n_dev=4, repeats=1, streams=2)
    assert res["diff"] <= cs.SYNTH_BOUND
    assert res["sharded_err"] <= cs.SYNTH_BOUND
    assert res["ulp"] == 0  # XLA:CPU sums the same way at every shape


def test_max_ulp():
    a = np.array([1.0, -2.0], np.float32)
    b = np.nextafter(a, np.float32(np.inf))
    assert cs._max_ulp(a, a) == 0
    assert cs._max_ulp(a, b) == 1


# -- compile cache ---------------------------------------------------------


def _cache_in_child(env):
    code = ("import jax; from nvorbis_tpu.utils.jaxinit import "
            "ensure_compile_cache; ensure_compile_cache(); "
            "print(jax.config.jax_compilation_cache_dir)")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("NVT_NO_COMPILE_CACHE", None)
    assert _cache_in_child(env) == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_honours_env(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    env.pop("NVT_NO_COMPILE_CACHE", None)
    assert _cache_in_child(env) == str(tmp_path)


def test_cache_dir_helper(monkeypatch):
    from nvorbis_tpu.utils.jaxinit import cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert cache_dir() == "/some/where"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert cache_dir() == os.path.join(ROOT, ".jax_cache")


# -- no silent fallback ----------------------------------------------------


def test_auto_raises_when_device_pipeline_fails(monkeypatch):
    from nvorbis_tpu.engine import batcher

    def broken(self, decoder, readahead=2048):
        raise RuntimeError("device plane unavailable")

    monkeypatch.setattr(batcher.JaxPipeline, "__init__", broken)
    monkeypatch.delenv("NVT_ENGINE", raising=False)
    path = corpus.fixture_path(corpus.STEREO)  # above NVT_DEVICE_MIN_SECS
    with pytest.raises(RuntimeError, match="device plane unavailable"):
        nv.VorbisReader(path)
    with pytest.raises(RuntimeError, match="device plane unavailable"):
        nv.VorbisReader(path, engine="jax")
    # short streams and the host engine never build the device plane
    nv.VorbisReader(corpus.fixture_path(corpus.MONO_SHORT)).dispose()
    nv.VorbisReader(path, engine="host").dispose()


def test_nvt_engine_routes_auto(monkeypatch):
    monkeypatch.setenv("NVT_ENGINE", "host")
    r = nv.VorbisReader(corpus.fixture_path(corpus.STEREO))
    assert type(r._stream_decoder._pipeline).__name__ == "HostPipeline"
    r.dispose()
    from nvorbis_tpu.parallel.batch import BatchDecoder

    raw = open(corpus.fixture_path(corpus.MONO_SHORT), "rb").read()
    assert BatchDecoder([raw])._host_mode
    monkeypatch.delenv("NVT_ENGINE")
    assert not BatchDecoder([raw])._host_mode


def test_devinfo_card_without_nvidia_smi(monkeypatch, tmp_path):
    from nvorbis_tpu.utils import devinfo

    monkeypatch.setenv("PATH", str(tmp_path))
    assert devinfo.card() == "nvidia-smi missing"
    d = devinfo.device()
    assert d["platform"] == "cpu" and d["count"] >= 1
