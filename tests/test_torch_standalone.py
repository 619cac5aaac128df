"""The PyTorch port stands alone: it imports torch and numpy, never jax,
and nothing of the JAX package."""

import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "go_raytracing_tpu_torch"

FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|go_raytracing_tpu)(?:[.\s,]|$)"
    r"|import_module\(\s*['\"](?:jax|go_raytracing_tpu)['\".]"
    r"|__import__\(\s*['\"](?:jax|go_raytracing_tpu)['\".]",
    re.MULTILINE,
)


def _sources():
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")
             and "_build" not in p.parts]
    return files + [ROOT / "chip_smoke.py"]


def test_no_source_imports_jax_or_the_jax_package():
    files = _sources()
    assert len(files) > 20 and all(f.exists() for f in files)
    for f in files:
        text = f.read_text()
        assert "import jax" not in text, f
        m = FORBIDDEN.search(text)
        assert m is None, (f, m.group(0) if m else None)


def test_package_imports_with_jax_unimportable():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "go_raytracing_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import go_raytracing_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for n in names:
            importlib.import_module(n)
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "go_raytracing_tpu")]
        assert not bad, bad
        scene, cam = pkg.load_scene("quads", device="cpu")
        import dataclasses
        cam = dataclasses.replace(cam, image_width=8, samples_per_pixel=1, max_depth=2)
        img = pkg.render_image(scene, cam, device="cpu")
        assert tuple(img.shape) == (8, 8, 3)
        loss, grads = pkg.render_grad(scene, cam, img, device="cpu")
        assert loss.ndim == 0 and set(grads) == set(pkg.trainable_params(scene))
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "go_raytracing_tpu")]
        assert not bad, bad
        print("OK", len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 15


def test_gradient_modules_are_part_of_the_package():
    """The gradient slice's modules and kernel sources are among the files
    the two tests above scan and import."""
    names = {str(p.relative_to(PORT)) for p in _sources()[:-1]}
    assert {"render/grad.py", "parallel/sharding.py", "csrc/wavefront.cu",
            "csrc/wavefront_grad.cu"} <= names


def test_pathwise_sources_are_part_of_the_package():
    """The pathwise tier's kernel source and the header it shares with the
    tracing kernels are scanned too, and the pathwise path runs with JAX
    unimportable."""
    names = {str(p.relative_to(PORT)) for p in _sources()[:-1]}
    assert {"csrc/wavefront_grad_pathwise.cu", "csrc/wavefront_common.cuh"} <= names
    code = textwrap.dedent("""
        import dataclasses, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "go_raytracing_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import go_raytracing_tpu_torch as pkg
        scene, cam = pkg.load_scene("cornell-glossy", device="cpu")
        cam = dataclasses.replace(cam, image_width=16, aspect_ratio=1.0,
                                  samples_per_pixel=4)
        img = pkg.render(scene, cam, device="cpu") / 4 * 0.8
        loss, grads = pkg.render_grad(scene, cam, img, device="cpu")
        assert set(grads) == set(pkg.trainable_params(scene))
        assert bool(grads["fuzz"].any()) and bool(grads["ior"].any())
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "go_raytracing_tpu")]
        assert not bad, bad
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
