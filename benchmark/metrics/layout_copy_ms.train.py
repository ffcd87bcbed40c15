"""layout_copy_ms.train: device milliseconds a train step of the layout
conversions around cuDNN (NCHW <-> NHWC copies and transposes), by the
kernel-name patterns of ``tools/profile_summary.py``. Layer: the models
(``models/bpbreid.py`` over its backbone)."""
import re

LAYOUT_COPY = re.compile(r'nchwtonhwc|nhwctonchw|transpose')


def read(ctx):
    t = ctx.traced
    if t is None or not t.steps or not t.device_names(LAYOUT_COPY):
        return None
    return t.device_us(LAYOUT_COPY) / t.steps / 1e3
