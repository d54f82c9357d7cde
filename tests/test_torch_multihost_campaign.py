"""Host-kill campaign twin: the port's ``chaos/multihost.py`` over the
port's ``multihost_spec`` and ``Fleet.kill_host`` against the JAX
campaign, on the CPU (each a subprocess fleet of two host groups, one
after the other).

Compared exactly: the docs, the token count, each doc's final text as a
fresh verifier reads it (every token exactly once, nothing else), the
injections (one host kill, one boot crash) and reconnects, and
``boot.part.full_replay == 0`` with lazy boots ≥ the victim's docs.
What the scheduler decides (``resubmitted``, owner ids, which docs boot
fresh) is not compared.
"""

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import token_campaign

from fluidframework_tpu.chaos import multihost as jax_multihost
from fluidframework_tpu_torch.chaos import multihost


def _seed_fixed(root: str, seed: int, monkeypatch) -> dict:
    got = token_campaign(root, "multihost", seed, monkeypatch)
    assert got["boot"].get("boot.part.full_replay", 0) == 0
    assert got["boot"]["boot.part.lazy"] >= got["docs"] // 2
    counters = got["counters"]
    return {"docs": got["docs"], "tokens": got["tokens"],
            "final": got["final"],
            "injected": {k: v for k, v in counters.items()
                         if k.startswith("chaos.injected.")},
            "reconnects": counters["chaos.recovered.reconnect"]}


def _multihost_equals_jax(seed: int, monkeypatch):
    assert (multihost.VICTIM, multihost.TTL) \
        == (jax_multihost.VICTIM, jax_multihost.TTL)
    got = _seed_fixed("fluidframework_tpu_torch", seed, monkeypatch)
    assert got["docs"] == 4 and got["tokens"] == 24
    assert got["injected"] == {"chaos.injected.boot_crash": 1,
                               "chaos.injected.host_kill": 1}
    assert got == _seed_fixed("fluidframework_tpu", seed, monkeypatch)


def test_multihost_quick_equals_jax(monkeypatch):
    """Kill -9 one host group with tokens in flight, respawn it into a
    boot that crashes mid-rehydration through the remote table door,
    respawn it clean: the survivor never stalls and every token lands
    exactly once, as in the JAX campaign."""
    _multihost_equals_jax(0, monkeypatch)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [7, 42])
def test_multihost_other_seeds(seed, monkeypatch):
    _multihost_equals_jax(seed, monkeypatch)
