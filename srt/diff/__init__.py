from srt.diff.inverse import (  # noqa: F401
    render_pixels, image_loss, make_train_step, splice)
