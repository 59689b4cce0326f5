"""Device ms a call of the encoders: VGG19 and DINOv2 (`roma.vgg`,
`roma.dinov2`) or XFeat (`tiny.xfeat`)."""

from perfbench.core.trace import span_device_ms


def read(r):
    return span_device_ms(r.profile, r"roma\.vgg|roma\.dinov2|tiny\.xfeat")
