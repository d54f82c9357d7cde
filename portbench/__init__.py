"""The benchmark of the PyTorch and CUDA port (``fluidframework_tpu_torch``).

``T0`` is read when the package is first imported, the earliest point of
a run: a run's set-up time is measured from it.
"""

import time

T0 = time.perf_counter()
