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
integrator) by both engines; then the two scene files chip_smoke.py
renders on the card (an OBJ, a binary PLY, an EXR bitmap, a sunsky), each
through `cli.main` at 8x8 on the CPU into an EXR that the port reads
back, and the PIZ decoder's build and a call.  An audit hook fails the
child if it opens any file under mcpt_tpu/ (the reference's .npz tables,
its piz.c).  A scan of the sources catches an import statement of any of
the blocked packages, even one on a path the subprocess does not run, and
any string that names a path under mcpt_tpu/ other than a `file.py:line`
citation (the kernels line's "replaces").
"""

import ast
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "mcpt_tpu")

_CHILD = r"""
import importlib, importlib.abc, os, pkgutil, sys, tempfile

BLOCKED = {blocked!r}
REFERENCE = os.path.join({root!r}, "mcpt_tpu") + os.sep
opened = []

def audit(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        path = os.path.abspath(os.fsdecode(args[0]))
        if path.startswith(REFERENCE):
            opened.append(path)

sys.addaudithook(audit)

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
import numpy as np
from mcpt_tpu_torch import cli, native
from mcpt_tpu_torch.utils.image import read_exr
with tempfile.TemporaryDirectory() as tmp:
    for write in (chip_smoke.write_cornell_scene,
                  chip_smoke.write_matpreview_scene):
        xml = write(os.path.join(tmp, write.__name__), res=8, spp=1)
        out = os.path.join(tmp, write.__name__ + ".exr")
        assert cli.main(["-i", xml, "-o", out, "--depth-max", "3",
                         "--device", "cpu"]) == 0
        img = read_exr(out)
        assert img.shape == (8, 8, 3) and np.isfinite(img).all(), xml
        assert img.mean() > 0, xml
rc, _ = native.piz_decode(b"", [1], [1])
assert rc == -11, rc
assert not opened, opened
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


#: a citation of the reference, `mcpt_tpu/<path>.py:<line>` (the kernels
#: line's "replaces"), names a place and reads nothing
_CITATION = re.compile(r"mcpt_tpu/[\w/]+\.py:\d+")
_REFERENCE_PATH = re.compile(r"(^|[^\w])mcpt_tpu([/\\]|$)")


def reference_paths(source: str) -> list:
    """The string constants of `source`, docstrings aside, that name a
    path under mcpt_tpu/: a string "mcpt_tpu" (a path component) or one
    holding mcpt_tpu/... that is not a file:line citation."""
    tree = ast.parse(source)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    hits = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            text = _CITATION.sub("", node.value)
            if _REFERENCE_PATH.search(text):
                hits.append(f"line {node.lineno}: {node.value[:80]!r}")
    return hits


def test_no_path_under_the_reference():
    files = sorted((ROOT / "mcpt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)} {h}" for f in files
            for h in reference_paths(f.read_text())]
    assert not hits, hits
    # the scan sees the ways a module would reach the reference's files
    for bad in ('np.load(os.path.join(ROOT, "mcpt_tpu", "scene", "x.npz"))',
                'SRC = Path(__file__).parents[1] / "mcpt_tpu/native/piz.c"',
                'open(f"{root}/mcpt_tpu/scene/hosek_data.npz")'):
        assert reference_paths(bad), bad
    for fine in ('"""Counterpart of mcpt_tpu/scene/parser.py."""',
                 'K = {"replaces": "mcpt_tpu/ops/pallas_dense.py:31"}',
                 'import mcpt_tpu_torch.scene'):
        assert not reference_paths(fine), fine
