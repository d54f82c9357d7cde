"""ack_p95_ms: the 95th percentile, over every boxcar submitted in the
window, of submit to the submitter's own broadcast: one sample a boxcar,
all of them, in every run (the count ends standard error as
``ack_samples``)."""

from portbench.yardstick.stats import percentile

LAYER = "end to end"


def read(run):
    samples = run.samples.get("ack_ms")
    if not samples:
        return None
    return percentile(samples, 0.95)
