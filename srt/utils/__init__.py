from srt.utils.metrics import RenderMetrics  # noqa: F401
