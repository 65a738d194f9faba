"""Host seconds of the scene's build: `load_config` of the scene file and
`Renderer(config)` (parse, compile, BVH and SAH, tables), up to a
synchronised device."""


def read(ctx):
    return ctx["commit_s"]
