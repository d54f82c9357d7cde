"""The port's agent scheduler and intelligence runner against the JAX
package's: exclusive task ownership over the consensus register, handed
over on a sequenced leave or a release, and the elected runner's
analysis published into the document.

Each test is the twin of the test of the same name in
``tests/test_agent_scheduler.py`` or ``tests/test_intel_runner.py``: its
scenario runs with the JAX test's assertions on each package
(``torch_stack_fixtures.twin``); the owners, callbacks and results it
observes are noted, and every container's channels (the scheduler's
register collection, the results map, the text) agree between the
packages exactly, client ids mapped by first appearance. Containers close
as the JAX tests close them, so the leaves are sequenced in the same
order on both sides.
"""

from tests.torch_stack_fixtures import twin


def boot_pair(t):
    scheduler = t.mod("runtime.agent_scheduler").AgentScheduler
    c1 = t.loader.resolve("t", "doc")
    c2 = t.loader.resolve("t", "doc")
    c1.runtime.create_data_store("default")
    s1 = scheduler(c1)
    s2 = scheduler(c2)
    return c1, c2, s1, s2


def _exactly_one_volunteer_wins(t):
    c1, c2, s1, s2 = boot_pair(t)
    s1.pick("intel")
    s2.pick("intel")
    assert s1.owner("intel") == s2.owner("intel")
    assert s1.owns("intel") != s2.owns("intel")  # exactly one
    t.note(s1.owner("intel"), s1.owns("intel"), s2.owns("intel"))


def test_exactly_one_volunteer_wins():
    twin(_exactly_one_volunteer_wins)


def _ownership_transfers_on_leave(t):
    c1, c2, s1, s2 = boot_pair(t)
    events = []
    s1.pick("summarizer", lambda owned: events.append(("c1", owned)))
    s2.pick("summarizer", lambda owned: events.append(("c2", owned)))
    first_owner = s1.owner("summarizer")
    loser = s2 if s1.owns("summarizer") else s1
    winner_container = c1 if s1.owns("summarizer") else c2
    winner_container.close()  # sequenced leave reaches the survivor
    assert loser.owns("summarizer")
    assert loser.owner("summarizer") != first_owner
    assert ("c1", True) in events or ("c2", True) in events
    t.note(first_owner, loser.owner("summarizer"), events)


def test_ownership_transfers_on_leave():
    twin(_ownership_transfers_on_leave)


def _release_hands_off_to_volunteer(t):
    c1, c2, s1, s2 = boot_pair(t)
    s1.pick("task")
    assert s1.owns("task")
    s2.pick("task")
    assert not s2.owns("task")
    s1.release("task")
    assert s2.owns("task") and not s1.owns("task")
    t.note(s1.owner("task"), s2.owner("task"))


def test_release_hands_off_to_volunteer():
    twin(_release_hands_off_to_volunteer)


def _owner_visible_from_non_volunteers(t):
    c1, c2, s1, s2 = boot_pair(t)
    s1.pick("solo")
    assert s2.owner("solo") == c1.client_id
    assert "solo" in s2.tasks
    t.note(s2.owner("solo"), s2.tasks)


def test_owner_visible_from_non_volunteers():
    twin(_owner_visible_from_non_volunteers)


# ---------------------------------------------------------- intel runner

def _single_runner_analyzes_and_everyone_sees(t):
    runner = t.mod("runtime.intel_runner").IntelRunner
    c1 = t.loader.resolve("t", "doc")
    c2 = t.loader.resolve("t", "doc")
    ds = c1.runtime.create_data_store("default")
    text = ds.create_channel("text", "shared-string")
    text.insert_text(0, "hello collaborative world")
    r1 = runner(c1)
    r2 = runner(c2)
    assert r1.is_running != r2.is_running  # exactly one works

    # analysis converged to every replica through the total order
    res2 = c2.runtime.get_data_store("default").get_channel("intel-results")
    assert res2.get("words") == 3
    assert res2.get("longest_word") == "collaborative"

    # live re-analysis on edits from ANY client
    editor = (c2 if r1.is_running else c1).runtime \
        .get_data_store("default").get_channel("text")
    editor.insert_text(0, "extraordinarily ")
    assert res2.get("words") == 4
    assert res2.get("longest_word") == "extraordinarily"
    t.note(r1.is_running, r1.runs, r2.runs)


def test_single_runner_analyzes_and_everyone_sees():
    twin(_single_runner_analyzes_and_everyone_sees)


def _runner_fails_over_on_departure(t):
    runner = t.mod("runtime.intel_runner").IntelRunner
    c1 = t.loader.resolve("t", "doc")
    c2 = t.loader.resolve("t", "doc")
    ds = c1.runtime.create_data_store("default")
    text = ds.create_channel("text", "shared-string")
    text.insert_text(0, "one two")
    r1 = runner(c1)
    r2 = runner(c2)
    worker, standby = (r1, r2) if r1.is_running else (r2, r1)
    worker.container.close()
    assert standby.is_running
    s2 = standby.container.runtime.get_data_store("default") \
        .get_channel("text")
    s2.insert_text(0, "zero ")
    assert standby.results.get("words") == 3
    assert standby.results.get("analyzed_by") == \
        standby.container.client_id
    t.note(r1.is_running, worker.runs, standby.runs)


def test_runner_fails_over_on_departure():
    twin(_runner_fails_over_on_departure)
