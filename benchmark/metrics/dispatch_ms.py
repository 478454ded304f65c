"""Host wall per block inside ``Renderer.render_frames_device``: the
scene's prepare and the dispatch, with no wait for the device (the
harness's "dispatch" span over the window's blocks)."""


def read(ctx):
    if ctx["layer"] != "renderer" or not ctx["blocks"]:
        return None
    return 1e3 * ctx["spans"].get("dispatch", 0.0) / ctx["blocks"]
