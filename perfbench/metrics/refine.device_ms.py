"""Device ms a call of the refinement: the ConvRefiners of every scale and
pass (`roma.refiner<s>`) or Tiny's matchers (`tiny.coarse_matcher`,
`tiny.fine_matcher`)."""

from perfbench.core.trace import span_device_ms


def read(r):
    return span_device_ms(r.profile, r"roma\.refiner\d+|tiny\.(coarse|fine)_matcher")
