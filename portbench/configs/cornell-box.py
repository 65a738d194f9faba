"""cornell-box: the canonical Cornell-box job and camera (1024 x 1024,
256 spp, maxDepth 65, fov_x 19.5 from z = 6.8) in the layout of the
port's built-in box (`reduced`): five diffuse walls, two diffuse boxes
and a 0.5 x 0.5 area light, 36 triangles."""

from portbench.scene import Material, Scene, cube, merge, rectangle


def make_scene(cfg: dict) -> Scene:
    alb = cfg["albedo"]
    mats = {name: Material("diffuse", albedo=tuple(c)) for name, c in alb.items()}
    mats["light"] = Material("emitter", radiance=tuple(cfg["light_radiance"]))
    white = merge("white", [
        rectangle("floor", "white", rot_x=-90, t=(0, 0, 0)),
        rectangle("ceiling", "white", rot_x=90, t=(0, 2, 0)),
        rectangle("back", "white", t=(0, 1, -1)),
        cube("short", "white", scale=(0.3, 0.3, 0.3), rot_y=-17,
             t=(0.35, 0.3, 0.3)),
        cube("tall", "white", scale=(0.3, 0.6, 0.3), rot_y=17,
             t=(-0.35, 0.6, -0.3)),
    ])
    meshes = [
        white,
        rectangle("red", "red", rot_y=90, t=(-1, 1, 0)),
        rectangle("green", "green", rot_y=-90, t=(1, 1, 0)),
        rectangle("light", "light", scale=(0.25, 0.25, 1), rot_x=90,
                  t=(0, 1.98, 0)),
    ]
    cam = cfg["camera"]
    return Scene(width=cfg["film"][0], height=cfg["film"][1], spp=cfg["spp"],
                 max_depth=cfg["max_depth"], rr_depth=cfg["rr_depth"],
                 fov_x=cam["fov_x"], origin=tuple(cam["origin"]),
                 target=tuple(cam["target"]), up=tuple(cam["up"]),
                 materials=mats, meshes=meshes)
