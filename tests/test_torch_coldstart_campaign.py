"""Cold-start campaign twin: the port's ``chaos/coldstart.py`` on a
subprocess fleet of the port's cores and storage process (``Fleet(spec,
subprocess=True)``) against the JAX campaign on the JAX package's fleet,
one after the other, on the CPU.

Compared exactly: the docs, the token count and each doc's final text as
a fresh verifier reads it (every token exactly once, nothing else). Each
run is held to ``boot.part.full_replay == 0``, lazy boots >= docs, at
least one core crashed by the boot-crash seam and one fleet kill; the
campaigns' constants (the 0.75 s lease TTL, the boot crash after 2
admitted boots, the tenant) are equal. Counts the scheduler decides
(``resubmitted``, how many cores the seam caught) are not compared.

The JAX core imports ``jax`` on its event loop at its first
``admin_summarize`` (``HostReplicaSource`` -> ``tpu_applier``; about 2 s
on this CPU), past the 0.56 s fence of the 0.75 s TTL, so a peer takes
the core's partitions before they checkpoint and the campaign fails its
own whole-log-replay check in most runs here (ROADMAP C8). The JAX
fleet's cores therefore import ``tpu_applier`` at start, before their
loop runs, through a ``sitecustomize`` on their ``PYTHONPATH``; the JAX
package runs unchanged.
"""

import os
import sys

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import token_campaign

from fluidframework_tpu.chaos import coldstart as jax_coldstart
from fluidframework_tpu_torch.chaos import coldstart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: imported by every process of the JAX fleet at start (``site``): a JAX
#: core loads ``tpu_applier`` (and so ``jax``) before its event loop
#: runs, not on it at its first summary
PREIMPORT = (
    "import sys\n"
    "if 'fluidframework_tpu.service.front_end' in sys.orig_argv:\n"
    "    import fluidframework_tpu.service.tpu_applier  # noqa: F401\n")


def _seed_fixed(root: str, seed: int, monkeypatch) -> dict:
    got = token_campaign(root, "coldstart", seed, monkeypatch)
    assert got["boot"].get("boot.part.full_replay", 0) == 0
    assert got["boot"]["boot.part.lazy"] >= got["docs"]
    assert got["crashed"] >= 1
    assert got["counters"]["chaos.injected.fleet_kill"] == 1
    return {k: got[k] for k in ("docs", "tokens", "final")}


def _coldstart_equals_jax(seed: int, monkeypatch, tmp_path):
    assert (coldstart.TTL, coldstart.BOOT_CRASH_AFTER, coldstart.TENANT) \
        == (jax_coldstart.TTL, jax_coldstart.BOOT_CRASH_AFTER,
            jax_coldstart.TENANT) == (0.75, 2, "chaos")
    got = _seed_fixed("fluidframework_tpu_torch", seed, monkeypatch)
    assert got["docs"] == 4 and got["tokens"] == 24
    site = tmp_path / "jax_fleet_site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(PREIMPORT)
    path = [str(site), REPO, os.environ.get("PYTHONPATH", "")]
    with pytest.MonkeyPatch.context() as env:
        env.setenv("PYTHONPATH", os.pathsep.join(p for p in path if p))
        assert got == _seed_fixed("fluidframework_tpu", seed, monkeypatch)


def test_coldstart_quick_equals_jax(monkeypatch, tmp_path):
    """Kill -9 the whole fleet with tokens in flight, restart it into a
    boot that crashes mid-rehydration, restart it clean: every token
    lands exactly once and every doc boots lazily, as in the JAX
    campaign."""
    _coldstart_equals_jax(0, monkeypatch, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [7, 42])
def test_coldstart_other_seeds(seed, monkeypatch, tmp_path):
    _coldstart_equals_jax(seed, monkeypatch, tmp_path)


def test_jax_fleet_preimport_runs_before_the_loop(tmp_path):
    """The ``sitecustomize`` above loads ``tpu_applier`` in a process
    started as a JAX core (``-m fluidframework_tpu.service.front_end``)
    and in no other."""
    import subprocess

    (tmp_path / "sitecustomize.py").write_text(PREIMPORT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path),
                                                       REPO]))
    probe = ("import sys; print('fluidframework_tpu.service.tpu_applier' "
             "in sys.modules)")
    other = subprocess.run([sys.executable, "-c", probe], env=env,
                           capture_output=True, text=True, timeout=120,
                           check=True)
    assert other.stdout.strip() == "False", other.stderr
    core = subprocess.run(
        [sys.executable, "-c", probe, "fluidframework_tpu.service.front_end"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert core.stdout.strip() == "True", core.stderr


def test_core_summary_path_imports_no_torch():
    """A core's ``admin_summarize`` path (the front end, the service
    summarizer and its host replica reading ``channel_stream``) imports
    no torch: importing it on the core's loop stalled the lease
    heartbeat past the 0.75 s TTL's fence (ROADMAP C8), as the JAX
    core's import of ``jax`` there still does."""
    import subprocess

    code = (
        "import sys\n"
        "from fluidframework_tpu_torch.service import front_end\n"
        "from fluidframework_tpu_torch.service.local_server import "
        "LocalServer\n"
        "from fluidframework_tpu_torch.service.service_summarizer import "
        "HostReplicaSource, ServiceSummarizer\n"
        "server = LocalServer()\n"
        "server.connect('t', 'd')\n"
        "source = HostReplicaSource(server)\n"
        "ServiceSummarizer(server, source)\n"
        "assert source.applied_seq('t', 'd') == 0\n"
        "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "False", out.stderr
