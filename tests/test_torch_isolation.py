"""mcpt_tpu_torch and chip_smoke.py must run where JAX does not exist.

The card's machine has no jax, jaxlib or flax, and importing anything of
mcpt_tpu runs mcpt_tpu/__init__.py, which imports jax.  A subprocess
blocks all four with a meta-path finder that raises ImportError, then
imports every module of the port and chip_smoke, and renders on the CPU
a 16x16, 1-spp Cornell box and an 8x8 frame of each mesh scene: one down
each large-scene route, and the materials scene (every BSDF family, the
batched body); and an 8x8 frame of the envmap scene (the envmap's alias
table, bitmap and bump textures, the batched body) and of the lights
scene (analytic emitters and quadrics, the alpha walk); and an 8x8 frame
of the volumetric-caustic scene (media, null shells, the volpath
integrator) by both engines.  A scan of the sources catches an import
statement of any of them, even one on a path the subprocess does not run.
"""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "mcpt_tpu")

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {blocked!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {{name}}")
        return None

for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})

import mcpt_tpu_torch
names = ["mcpt_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(mcpt_tpu_torch.__path__, "mcpt_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke

from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene.builtin import (
    cornell_box, cornell_mesh_march, cornell_mesh_materials, cornell_mesh_pairs,
    envmap_matpreview, lights_showcase, volumetric_caustic)
from mcpt_tpu_torch.ops.traversal import resolved_strategy
img = Renderer(cornell_box(res=16, spp=1), device="cpu").render(spp=1)
assert img.shape == (16, 16, 3) and (img >= 0).all() and img.mean() > 0, img.mean()
for make, route in ((cornell_mesh_march, "march"), (cornell_mesh_pairs, "pairs"),
                    (cornell_mesh_materials, "march")):
    r = Renderer(make(res=8, spp=1, depth_max=3), device="cpu")
    assert resolved_strategy(r.scene.geom) == route
    img = r.render(spp=1)
    assert img.shape == (8, 8, 3) and (img >= 0).all() and img.mean() > 0, route
for make in (envmap_matpreview, lights_showcase):
    r = Renderer(make(res=8, spp=1, depth_max=3), device="cpu")
    img = r.render(spp=1)
    assert img.shape == (8, 8, 3) and (img >= 0).all() and img.mean() > 0, make
r = Renderer(volumetric_caustic(res=8, spp=1, depth_max=4), device="cpu")
for engine in ("regen", "chunked"):
    img = r.render(spp=1, engine=engine)
    assert img.shape == (8, 8, 3) and (img >= 0).all() and img.mean() > 0, engine
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("modules", len(names))
"""


def test_port_imports_and_renders_without_jax():
    code = _CHILD.format(blocked=BLOCKED, root=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_modules = int(proc.stdout.split("modules")[-1])
    assert n_modules >= 20


_IMPORT = re.compile(
    r"^\s*(import|from)\s+(" + "|".join(BLOCKED) + r")\b", re.MULTILINE
)


def test_no_import_statement_of_jax_or_the_reference():
    files = sorted((ROOT / "mcpt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    hits = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in _IMPORT.finditer(f.read_text())
    ]
    assert not hits, hits
