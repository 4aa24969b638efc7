from srt.render.api import render, RenderConfig  # noqa: F401
from srt.render.camera import Camera  # noqa: F401
