"""gold-sphere: the matpreview rough-conductor job's film and spp
(1366 x 1024, 256 spp) on a scene of stand-ins (every one in `reduced`):
a 61,440-triangle UV sphere in rough gold (GGX, alpha 0.2), a diffuse
cube and a floor, both with checkerboards, under a constant sky and a
sun, to maxDepth 8."""

import numpy as np

from portbench.scene import (Material, Scene, cube, make_mesh, placement,
                             rectangle, uv_sphere)


def make_scene(cfg: dict) -> Scene:
    sp, gold, cb, fl = cfg["sphere"], cfg["gold"], cfg["cube"], cfg["floor"]
    mats = {
        "gold": Material("roughconductor", alpha=gold["alpha"],
                         eta=tuple(gold["eta"]), k=tuple(gold["k"])),
        "cube": Material("diffuse", checker=(tuple(cb["color0"]),
                                             tuple(cb["color1"]),
                                             cb["uv_scale"])),
        "floor": Material("diffuse", checker=(tuple(fl["color0"]),
                                              tuple(fl["color1"]),
                                              fl["uv_scale"])),
    }
    pos, nrm, faces = uv_sphere(sp["rings"], sp["segments"])
    r = sp["radius"]
    meshes = [
        make_mesh("sphere", "gold", pos, nrm, None, faces,
                  placement(scale=(r, r, r), t=tuple(sp["center"]))),
        cube("cube", "cube", scale=(cb["scale"],) * 3, rot_y=cb["rot_y"],
             t=tuple(cb["t"])),
        rectangle("floor", "floor", scale=(fl["scale"], fl["scale"], 1.0),
                  rot_x=-90),
    ]
    sun = cfg["sun"]
    d = np.asarray(sun["direction"], np.float64)
    cam = cfg["camera"]
    return Scene(width=cfg["film"][0], height=cfg["film"][1], spp=cfg["spp"],
                 max_depth=cfg["max_depth"], rr_depth=cfg["rr_depth"],
                 fov_x=cam["fov_x"], origin=tuple(cam["origin"]),
                 target=tuple(cam["target"]), up=tuple(cam["up"]),
                 materials=mats, meshes=meshes,
                 sky=tuple(cfg["sky_radiance"]),
                 sun=(tuple(d / np.linalg.norm(d)), tuple(sun["irradiance"])))
