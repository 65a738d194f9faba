"""`python -m mcpt_tpu_torch.cli`, the live preview and the renderer's
`progress` option and tile retry, against what the reference's versions
do (mcpt_tpu/cli.py, tests/test_preview.py,
tests/test_renderer_elastic.py).

The scene is chip_smoke.py's cornell.xml at 8x8.  Images the CLI writes
as EXR are float32 and must EQUAL the renderer's own; a checkpointed run
in two halves must equal the single run within rtol 1e-6 (the running
average `(acc * done + img * step) / (done + step)` is the reference's, so
only float reassociation could part them); a retried tile must equal the
lost one bit for bit.  Every MCPT_* variable a scene's mcpt.* tier or a
--set leaves behind is registered with monkeypatch, so that the test's
end restores the environment.
"""

import io
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
import mcpt_tpu_torch.render.renderer as R
from mcpt_tpu_torch import cli
from mcpt_tpu_torch.render.preview import PreviewServer
from mcpt_tpu_torch.scene.parser import load_config
from mcpt_tpu_torch.utils.image import read_exr, write_png

RES, SPP, DEPTH = 8, 4, 3


@pytest.fixture
def scene(tmp_path, monkeypatch):
    """cornell.xml at RES x RES, SPP spp, depth DEPTH; the MCPT_* names
    the CLI may set are restored when the test ends."""
    for name in ("MCPT_TILE_RETRIES", "MCPT_MARCH_BLOCK", "MCPT_TRAVERSAL"):
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    xml = chip_smoke.write_cornell_scene(str(tmp_path / "scene"), res=RES,
                                         spp=SPP)
    return xml, tmp_path


def _args(xml, out, *more):
    return ["-i", xml, "-o", str(out), "--depth-max", str(DEPTH),
            "--device", "cpu", *more]


def _direct(xml):
    return _renderer(xml).render(spp=SPP)


def test_cli_writes_the_renderers_image(scene, capsys):
    xml, tmp = scene
    assert cli.main(_args(xml, tmp / "out.exr")) == 0
    got = read_exr(str(tmp / "out.exr"))
    want = _direct(xml)
    assert got.shape == (RES, RES, 3) and want.mean() > 0
    np.testing.assert_array_equal(got, want)
    out = capsys.readouterr().out
    assert "[info] render 100.0%" in out and "committed on cpu" in out
    # a PNG output is the sRGB encoding of the same image
    assert cli.main(_args(xml, tmp / "out.png")) == 0
    write_png(str(tmp / "want.png"), want)
    assert (tmp / "out.png").read_bytes() == (tmp / "want.png").read_bytes()


def test_checkpoint_in_two_halves_equals_one_run(scene):
    xml, tmp = scene
    one = tmp / "one.npz"
    cli.main(_args(xml, tmp / "one.exr", "--checkpoint", str(one)))
    half = tmp / "half.npz"
    cli.main(_args(xml, tmp / "a.exr", "-s", str(SPP // 2),
                   "--checkpoint", str(half)))
    first = np.load(half)
    assert sorted(first.files) == ["film", "spp_done"]
    assert int(first["spp_done"]) == SPP // 2
    cli.main(_args(xml, tmp / "b.exr", "--checkpoint", str(half)))
    whole, resumed = np.load(one), np.load(half)
    assert int(whole["spp_done"]) == int(resumed["spp_done"]) == SPP
    np.testing.assert_allclose(resumed["film"], whole["film"], rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(read_exr(str(tmp / "b.exr")), resumed["film"])
    # each step is one sample (max(spp // 8, 1)) of frame `done`, folded
    # into the running average
    r = _renderer(xml)
    acc = None
    for done in range(SPP):
        img = r.render(spp=1, frame_base=done)
        acc = img if acc is None else (acc * done + img) / (done + 1)
    np.testing.assert_array_equal(whole["film"], acc)


def test_progressive_snapshot_names(scene):
    xml, tmp = scene
    cli.main(_args(xml, tmp / "frame.exr", "--progressive", "3"))
    names = sorted(p.name for p in tmp.glob("frame*.exr"))
    assert names == ["frame.exr", "frame_00003spp.exr", "frame_00004spp.exr"]
    np.testing.assert_array_equal(read_exr(str(tmp / "frame_00004spp.exr")),
                                  read_exr(str(tmp / "frame.exr")))


def test_set_fills_the_perf_tier(scene, monkeypatch):
    xml, tmp = scene
    seen = {}

    class Spy(R.Renderer):
        def __init__(self, config, device="cuda"):
            seen["perf"] = dict(config.perf)
            super().__init__(config, device=device)

    monkeypatch.setattr(R, "Renderer", Spy)
    cli.main(_args(xml, tmp / "out.exr", "-s", "1", "--set", "march_block=64",
                   "--set", " traversal = march "))
    assert seen["perf"] == {"tile_retries": "2", "march_block": "64",
                            "traversal": "march"}
    assert os.environ["MCPT_MARCH_BLOCK"] == "64"
    assert os.environ["MCPT_TRAVERSAL"] == "march"
    with pytest.raises(SystemExit):
        cli.main(_args(xml, tmp / "out.exr", "--set", "march_block"))


def test_serve_publishes_the_frames(scene, monkeypatch):
    xml, tmp = scene
    frames = []
    real = PreviewServer.update

    def update(self, img):
        frames.append(np.array(img))
        real(self, img)

    monkeypatch.setattr(PreviewServer, "update", update)
    cli.main(_args(xml, tmp / "out.exr", "--serve", "0"))
    assert len(frames) == SPP  # one frame a sample: max(spp // 8, 1)
    np.testing.assert_array_equal(frames[-1], read_exr(str(tmp / "out.exr")))


def test_default_device_without_cuda_raises(scene, monkeypatch):
    xml, tmp = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-i", xml, "-o", str(tmp / "out.exr")])
    assert not (tmp / "out.exr").exists()


def test_preview_server_serves_latest_frame():
    from PIL import Image

    srv = PreviewServer(port=0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{srv.port}"
        page = urllib.request.urlopen(f"{base}/").read()
        assert b"mcpt_tpu_torch preview" in page
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/frame.png")
        assert err.value.code == 404
        img = np.zeros((4, 6, 3), np.float32)
        img[..., 0] = 1.0  # pure red, linear
        srv.update(img)
        data = urllib.request.urlopen(f"{base}/frame.png?1").read()
        decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert decoded.shape == (4, 6, 3)
        assert (decoded[..., 0] == 255).all() and (decoded[..., 1] == 0).all()
        srv.update(np.zeros((2, 2, 3), np.float32))
        data = urllib.request.urlopen(f"{base}/frame.png?2").read()
        assert np.asarray(Image.open(io.BytesIO(data))).shape[:2] == (2, 2)
    finally:
        srv.close()


# ---------------------------------------------------------------- tile retry


def _renderer(xml):
    cfg = load_config(xml)
    cfg.integrator.depth_max = DEPTH
    return R.Renderer(cfg, device="cpu")


def test_lost_tile_recovers_bit_identical(scene, monkeypatch):
    xml, _ = scene
    r = _renderer(xml)
    clean = r.render(spp=SPP, tile=16, spp_chunk=2)
    real = R.render_tile_regen
    state = {"failed": 0}

    def flaky(scene_, cam, integ, idx, s, **kw):
        # the third tile's second spp chunk dies once, after its first
        # chunk's film is made
        if state["failed"] == 0 and int(idx[0]) == 32 and kw["sample_offset"]:
            state["failed"] = 1
            raise torch.cuda.OutOfMemoryError("injected: out of memory")
        return real(scene_, cam, integ, idx, s, **kw)

    monkeypatch.setattr(R, "render_tile_regen", flaky)
    with pytest.warns(UserWarning, match=r"tile \[32:48\] lost .*re-rendering"):
        recovered = r.render(spp=SPP, tile=16, spp_chunk=2)
    assert state["failed"] == 1
    np.testing.assert_array_equal(recovered, clean)


def test_exhausted_retries_raise(scene, monkeypatch):
    xml, _ = scene
    r = _renderer(xml)
    calls = []

    def dead(*a, **kw):
        calls.append(1)
        raise RuntimeError("injected: device gone")

    monkeypatch.setattr(R, "render_tile_regen", dead)
    monkeypatch.setenv("MCPT_TILE_RETRIES", "1")
    with pytest.raises(RuntimeError, match="injected"):
        with pytest.warns(UserWarning, match="attempt 1"):
            r.render(spp=2, tile=64)
    assert len(calls) == 2  # the first try and one retry


def test_refusals_are_not_retried(scene, monkeypatch):
    xml, _ = scene
    r = _renderer(xml)

    def refused(*a, **kw):
        raise NotImplementedError("item 22")

    monkeypatch.setattr(R, "render_tile_regen", refused)
    with pytest.raises(NotImplementedError):
        r.render(spp=1)


def test_progress_prints_percent_and_eta(scene, capsys):
    xml, _ = scene
    _renderer(xml).render(spp=2, tile=32, spp_chunk=1, progress=True)
    out = capsys.readouterr().out
    for pct in ("25.0%", "50.0%", "100.0%"):
        assert f"[info] render {pct:>6}  eta" in out
    assert "[info] render done in" in out


def test_trace_out_writes_the_calls_spans(scene):
    xml, tmp = scene
    out = tmp / "trace.json"
    assert cli.main(_args(xml, tmp / "out.exr", "--trace-out", str(out))) == 0
    events = json.loads(out.read_text())["traceEvents"]
    (call,) = [e for e in events if e["name"] == "render"]
    chunks = [e for e in events if e["name"] == "tile_chunk"]
    assert chunks
    for e in chunks:
        assert call["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= call["ts"] + call["dur"]
    assert {"scene.parse", "scene.compile", "scene.accel", "trace",
            "sync"} <= {e["name"] for e in events}
