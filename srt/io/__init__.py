from srt.io.image import load_image, write_ppm, write_png  # noqa: F401
