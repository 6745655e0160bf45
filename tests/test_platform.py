"""What the package needs from its platform: the pytree dataclass helper,
the import surface, the compile-cache helper, and chip_smoke.py's refusal to
run without a GPU (plus its compiled-stage checks, on a GPU host)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weiner_slamit_v2_tpu.utils import struct

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray | None = None
    size: int = struct.field(static=True, default=3)


class TestStruct:
    def test_pytree_roundtrip(self):
        p = _Pair(a=jnp.arange(3.0), b=jnp.ones(2), size=5)
        leaves, treedef = jax.tree.flatten(p)
        assert len(leaves) == 2
        q = jax.tree.unflatten(treedef, [2 * x for x in leaves])
        assert isinstance(q, _Pair) and q.size == 5
        np.testing.assert_array_equal(np.asarray(q.a), [0.0, 2.0, 4.0])
        # None fields are empty subtrees, not leaves
        assert len(jax.tree.leaves(_Pair(a=jnp.zeros(1)))) == 1

    def test_replace_is_a_frozen_copy(self):
        p = _Pair(a=jnp.zeros(2))
        q = p.replace(a=jnp.ones(2))
        assert float(p.a.sum()) == 0.0 and float(q.a.sum()) == 2.0
        with pytest.raises(dataclasses.FrozenInstanceError):
            p.a = jnp.ones(2)

    def test_static_field_under_jit(self):
        """A static field is part of the tree definition: jit sees it as a
        Python constant and retraces when it changes."""
        traces = []

        @jax.jit
        def f(p):
            traces.append(p.size)
            return p.a * p.size

        assert float(f(_Pair(a=jnp.ones(1), size=2))[0]) == 2.0
        assert float(f(_Pair(a=jnp.zeros(1), size=2))[0]) == 0.0
        assert float(f(_Pair(a=jnp.ones(1), size=4))[0]) == 4.0
        assert traces == [2, 4]


_BLOCKED_IMPORT = """
import importlib.abc, sys
BLOCKED = {"flax", "yaml", "PIL", "matplotlib"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
import weiner_slamit_v2_tpu.tracking.system
import weiner_slamit_v2_tpu.cli
import weiner_slamit_v2_tpu.models.posenet
assert not BLOCKED & set(m.split(".")[0] for m in sys.modules)
print("IMPORTED")
"""


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.update(extra)
    return env


class TestImportSurface:
    def test_imports_without_optional_packages(self):
        r = subprocess.run(
            [sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
            text=True, timeout=300, env=_env(), cwd=REPO,
        )
        assert r.returncode == 0, r.stderr[-3000:]
        assert "IMPORTED" in r.stdout


_CACHE_PROBE = """
import jax
from weiner_slamit_v2_tpu.utils.compile_cache import enable_compile_cache
print(enable_compile_cache())
print(jax.config.jax_compilation_cache_dir)
"""


class TestCompileCache:
    def _run(self, env):
        r = subprocess.run(
            [sys.executable, "-c", _CACHE_PROBE], capture_output=True,
            text=True, timeout=300, env=env, cwd=REPO,
        )
        assert r.returncode == 0, r.stderr[-3000:]
        return r.stdout.split()

    def test_env_var_is_honoured(self, tmp_path):
        d = str(tmp_path / "cache")
        assert self._run(_env(JAX_COMPILATION_CACHE_DIR=d)) == [d, d]

    def test_default_is_a_fixed_ignored_path_in_the_checkout(self):
        env = _env()
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        want = os.path.join(REPO, ".jax_cache")
        assert self._run(env) == [want, want]
        ignored = subprocess.run(
            ["git", "check-ignore", "-q", os.path.join(want, "entry")],
            cwd=REPO,
        )
        assert ignored.returncode in (0, 128)  # 128: not a git checkout


class TestChipSmoke:
    def test_refuses_to_run_without_a_gpu(self):
        r = subprocess.run(
            [sys.executable, "chip_smoke.py"], capture_output=True,
            text=True, timeout=300, env=_env(), cwd=REPO,
        )
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
        assert "no GPU" in r.stderr

    @pytest.mark.gpu
    def test_compiled_stages_match_numpy_on_gpu(self, gpu_device):
        sys.path.insert(0, REPO)
        import chip_smoke

        cfg, _, _ = chip_smoke.make_cfg()
        with jax.default_device(gpu_device):
            chip_smoke.check_fast(cfg)
            chip_smoke.check_fuse_matcher(cfg)
