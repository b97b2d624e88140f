"""Profiling utils + CLI surface tests."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest


class TestRunMetrics:
    def test_phases_and_write(self, tmp_path):
        from mixmogam_tpu.utils.profiling import RunMetrics

        rm = RunMetrics("t")
        with rm.phase("a"):
            x = np.arange(10).sum()
        with rm.phase("b") as box:
            box["fence"] = None
        rm.set("x", int(x))
        rate = rm.throughput("r", 100, "a")
        assert rate > 0
        p = tmp_path / "m.json"
        rm.write(str(p))
        d = json.loads(p.read_text())
        assert set(d["phases_s"]) == {"a", "b"}
        assert d["metrics"]["x"] == 45

    def test_debug_nans_context(self):
        import jax

        from mixmogam_tpu.utils.profiling import debug_nans

        prev = jax.config.jax_debug_nans
        with debug_nans(True):
            assert jax.config.jax_debug_nans is True
        assert jax.config.jax_debug_nans == prev


class TestCli:
    def test_info(self, capsys):
        from mixmogam_tpu.cli import main

        assert main(["info"]) == 0
        out = capsys.readouterr().out
        assert "mixmogam-tpu" in out and "backend" in out

    def test_bad_method_rejected(self):
        from mixmogam_tpu.cli import main

        with pytest.raises(SystemExit):
            main(["run", "a.csv", "b.csv", "--method", "nope"])

    def test_esp_to_refine_iters(self):
        from mixmogam_tpu.ops.reml import esp_to_refine_iters

        assert esp_to_refine_iters(1e-6) == 18
        assert esp_to_refine_iters(1e-30) == 64  # clamped
        assert esp_to_refine_iters(1.0) == 16    # clamped


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_python(args, cwd, **env):
    full = {k: v for k, v in os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}
    full.update(JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=120)


class TestCompileCache:
    """JAX_COMPILATION_CACHE_DIR wins; otherwise the cache sits at a
    fixed <checkout>/.jax_cache (a fresh process each: the rule runs
    when mixmogam_tpu.ops is imported)."""

    @pytest.mark.parametrize("from_env", [True, False])
    def test_cache_dir_rule(self, tmp_path, from_env):
        env = ({"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")}
               if from_env else {})
        r = _run_python(
            ["-c", "import jax, mixmogam_tpu.ops; "
                   "print(jax.config.jax_compilation_cache_dir)"],
            cwd=REPO, **env)
        assert r.returncode == 0, r.stderr
        want = (str(tmp_path / "cc") if from_env
                else os.path.join(REPO, ".jax_cache"))
        assert r.stdout.strip().splitlines()[-1] == want


class TestChipSmoke:
    """chip_smoke.py never reports a result without a GPU."""

    @pytest.mark.parametrize("alone", [False, True])
    def test_fails_without_gpu(self, tmp_path, alone):
        script = os.path.join(REPO, "chip_smoke.py")
        if alone:       # a directory with the script and no package
            shutil.copy(script, tmp_path)
            script = str(tmp_path / "chip_smoke.py")
        r = _run_python([script], cwd=str(tmp_path))
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
