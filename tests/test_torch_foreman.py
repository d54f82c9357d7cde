"""Foreman twin: the port's ``service/foreman.py`` against the JAX
package's, on the CPU.

The three cases of ``tests/test_foreman.py`` run the same script under
one frozen clock through both packages' ``Foreman``: every task each
worker was handed (id, payload, attempt), the reassignment count, every
completion's answer and every stored result must be equal exactly.
"""

import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu.service.foreman import Foreman as JaxForeman
from fluidframework_tpu_torch.service.foreman import Foreman

FOREMEN = {"torch": Foreman, "jax": JaxForeman}


def _both(script):
    got = script(FOREMEN["torch"])
    assert got == script(FOREMEN["jax"])
    return got


def mk(cls, clock):
    return cls(clock=lambda: clock[0], worker_timeout=10.0)


def test_tasks_spread_least_loaded_and_complete():
    def script(cls):
        clock = [0.0]
        f = mk(cls, clock)
        got = {"a": [], "b": []}
        f.register_worker("a", lambda t: got["a"].append(t))
        f.register_worker("b", lambda t: got["b"].append(t))
        for i in range(6):
            f.enqueue(f"t{i}", {"n": i})
        done = [f.complete(w, t["task_id"], t["payload"]["n"] * 2)
                for w in ("a", "b") for t in got[w]]
        return got, done, f.pending_count(), f.result("t4")

    got, done, pending, result = _both(script)
    assert len(got["a"]) == 3 and len(got["b"]) == 3
    assert all(done) and pending == 0 and result == 8


def test_dead_worker_tasks_reassign_and_stale_completion_refused():
    def script(cls):
        clock = [0.0]
        f = mk(cls, clock)
        got = {"a": [], "b": []}
        f.register_worker("a", lambda t: got["a"].append(t))
        f.enqueue("job", {"x": 1})
        clock[0] = 5.0
        f.register_worker("b", lambda t: got["b"].append(t))
        clock[0] = 20.0
        f.heartbeat("b")
        f.check_workers()
        out = [f.reassignments, f.complete("a", "job", "stale result"),
               f.result("job"), f.complete("b", "job", "fresh result"),
               f.result("job")]
        return got, out

    got, out = _both(script)
    assert len(got["a"]) == 1
    assert len(got["b"]) == 1 and got["b"][0]["attempt"] == 2
    assert out == [1, False, None, True, "fresh result"]


def test_tasks_queue_until_a_worker_exists():
    def script(cls):
        f = mk(cls, [0.0])
        f.enqueue("early", {"k": 1})
        pending = f.pending_count()
        got = []
        f.register_worker("late", got.append)
        return pending, got

    pending, got = _both(script)
    assert pending == 1
    assert [t["task_id"] for t in got] == ["early"]
