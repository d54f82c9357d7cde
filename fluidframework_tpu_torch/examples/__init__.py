"""The port's example apps, each a copy of its JAX counterpart under the
repo's ``examples/``: ``shared_text``, ``clicker``, ``table_doc``, ``todo``,
``canvas``, ``sudoku`` and ``album``. Each exposes ``run_clients(port)``
(the dev host's seam, ``python -m fluidframework_tpu_torch.host <app>``),
``run_demo()`` and its own actor CLI.
"""
