"""ROADMAP C2 in the client stack: work on a document's stream done on the
app's thread beside the driver's reader thread.

Two races, each made deterministic in process, each shown in the JAX
package's client stack and repaired in the port's.

**Submit inside the replay.** An op the app submits on its own thread
while the reader thread replays the pending ops of a fresh connection.

A creator makes a data store and a channel before its join comes back,
so both attach ops wait as pending state. Its join arrives on the reader
thread (as the socket driver's broadcast does), the connection goes
active and the reader thread replays the two attaches; meanwhile the app
thread, seeing the container connected, submits the first channel op.
The JAX runtime sends that op between the replayed data-store attach and
the replayed channel attach, so the sequenced stream holds a channel op
before its channel's attach, and every client that boots by catching up
raises ``KeyError: op for unknown channel`` (the dev-host tests' failure
under load). The socket driver's reader thread dispatches under the
connection's lock, but the app thread's submit never took it. The port's
runtime holds it (the delta manager's ``dispatch_guard``) around
record-then-send and around the replay: the app's op goes after the
replay, and a booting client reads the counter.

The interleaving: once the reader thread has sent the first replayed
op, it waits until the app thread has had its chance (0.5 s; with the
lock the app thread is blocked that whole time).

**Catch-up beside the reader's drain.** A client that connects to a doc
with history catches up on the app's thread (``connect`` fetches the ops
before its handshake) while the reader thread delivers a live op, whose
gap makes it fetch and drain too. The JAX delta manager drains on both
threads at once: while the app thread is inside a channel's attach, the
reader thread processes the next op, for a channel not there yet, and
raises the same ``KeyError``. The port's catch-up holds the connection's
dispatch lock. The interleaving: the app thread, inside the attach, waits
until the reader thread processes an op (0.5 s; with the lock the reader
thread is blocked that whole time).
"""

from __future__ import annotations

import queue
import threading
import time
from importlib import import_module
from types import SimpleNamespace

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

ROOTS = {"jax": "fluidframework_tpu", "torch": "fluidframework_tpu_torch"}


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(
        LocalServer=import_module(
            f"{root}.service.local_server").LocalServer,
        LocalDocumentServiceFactory=import_module(
            f"{root}.driver.local").LocalDocumentServiceFactory,
        Loader=import_module(f"{root}.loader").Loader)


def _kind(contents) -> str:
    if contents.get("kind") == "attach":
        return "store attach"
    inner = contents.get("contents") or {}
    return "channel attach" if "attach" in inner else "channel op"


class _ReaderConnection:
    """A local delta connection whose broadcast reaches the client on a
    reader thread under the connection's ``lock`` (as the socket
    driver's reader thread dispatches), and whose first reader-thread
    submit, once sent, waits for ``app_went``. ``wire`` is the order the
    server sequenced."""

    def __init__(self, inner):
        self._inner = inner
        self.lock = threading.RLock()
        self.client_id = inner.client_id
        self.initial_sequence_number = inner.initial_sequence_number
        self.mode = getattr(inner, "mode", "write")
        self.on_disconnect = self.on_nack = self.on_signal = None
        self._handler = None
        self._inbox: queue.Queue = queue.Queue()
        inner.on_op = self._inbox.put
        self.wire: list = []
        self.replay_held = threading.Event()
        self.app_went = threading.Event()
        self.reader_error = None
        self._reader_submits = 0

    on_op = property(lambda self: self._handler,
                     lambda self, cb: setattr(self, "_handler", cb))

    def start_reader(self) -> None:
        def read():
            while (msg := self._inbox.get()) is not None:
                with self.lock:
                    try:
                        self._handler(msg)
                    except Exception as e:  # the reader stops, as the
                        self.reader_error = e  # socket driver's does
                        return

        self.reader = threading.Thread(target=read, name="reader",
                                       daemon=True)
        self.reader.start()

    def submit(self, messages) -> None:
        for m in messages:
            self.wire.append((threading.current_thread().name,
                              _kind(m.contents)))
        self._inner.submit(messages)
        if threading.current_thread().name == "reader":
            self._reader_submits += 1
            if self._reader_submits == 1:
                self.replay_held.set()
                self.app_went.wait(5.0)

    def submit_signal(self, content, type: str = "signal") -> None:
        self._inner.submit_signal(content, type)

    def close(self) -> None:
        self._inbox.put(None)
        self._inner.close()


class _ReaderFactory:
    def __init__(self, inner):
        self._inner = inner
        self.conns: list = []

    def create_document_service(self, tenant: str, doc: str):
        svc = self._inner.create_document_service(tenant, doc)
        factory = self

        class _Service:
            def connect_to_delta_stream(self, details=None):
                conn = _ReaderConnection(svc.connect_to_delta_stream(details))
                factory.conns.append(conn)
                return conn

            def __getattr__(self, name):
                return getattr(svc, name)

        return _Service()


def _race(P):
    """Run the interleaving on package ``P``; returns (the sequenced
    order as (thread, kind), the server)."""
    server = P.LocalServer()
    factory = _ReaderFactory(P.LocalDocumentServiceFactory(server))
    creator = P.Loader(factory).resolve("t", "clicks-doc")
    ds = creator.runtime.create_data_store("default")
    counter = ds.create_channel("clicks", "shared-counter")
    assert creator.runtime.pending.count == 2 and not creator.connected
    (conn,) = factory.conns
    conn.start_reader()
    assert conn.replay_held.wait(5.0)
    assert creator.connected
    app = threading.Thread(target=counter.increment, args=(1,), name="app")
    app.start()
    app.join(0.5)
    conn.app_went.set()
    app.join(5.0)
    assert not app.is_alive()
    deadline = time.monotonic() + 5.0
    while creator.runtime.pending.count:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    conn.close()
    return [row for row in conn.wire], server


def test_jax_runtime_sends_the_app_op_inside_the_replay():
    """The fault, in the JAX package's client stack."""
    P = _pkg(ROOTS["jax"])
    wire, server = _race(P)
    assert wire == [("reader", "store attach"), ("app", "channel op"),
                    ("reader", "channel attach")]
    with pytest.raises(KeyError, match="op for unknown channel clicks"):
        P.Loader(P.LocalDocumentServiceFactory(server)).resolve(
            "t", "clicks-doc")


def test_port_runtime_sends_the_app_op_after_the_replay():
    """The repair: the app thread waits for the replay; the stream holds
    both attaches before the op, and a client booting by catch-up reads
    the counter."""
    P = _pkg(ROOTS["torch"])
    wire, server = _race(P)
    assert wire == [("reader", "store attach"),
                    ("reader", "channel attach"), ("app", "channel op")]
    joiner = P.Loader(P.LocalDocumentServiceFactory(server)).resolve(
        "t", "clicks-doc")
    clicks = joiner.runtime.get_data_store("default").get_channel("clicks")
    assert clicks.value == 1


@pytest.mark.parametrize("pkg", sorted(ROOTS))
def test_ops_on_one_thread_keep_their_order(pkg):
    """Without a second thread both runtimes send in program order (the
    lock changes nothing there)."""
    P = _pkg(ROOTS[pkg])
    server = P.LocalServer()
    loader = P.Loader(P.LocalDocumentServiceFactory(server))
    c = loader.resolve("t", "plain")
    ds = c.runtime.create_data_store("default")
    counter = ds.create_channel("clicks", "shared-counter")
    for _ in range(3):
        counter.increment(2)
    assert c.runtime.pending.count == 0
    joiner = loader.resolve("t", "plain")
    assert joiner.runtime.get_data_store("default").get_channel(
        "clicks").value == 6


def test_dispatch_guard_holds_the_connections_dispatch_lock():
    """The guard takes the lock the connection dispatches under (its own
    where the connection has none), and takes the new connection's when
    the connection changes while it waits."""
    from fluidframework_tpu_torch.driver.local import (
        LocalDocumentServiceFactory,
    )
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.service.local_server import LocalServer

    c = Loader(LocalDocumentServiceFactory(LocalServer())).resolve(
        "t", "guard")
    dm = c.delta_manager
    assert getattr(dm.connection, "lock", None) is None
    with dm.dispatch_guard():
        assert dm._submit_lock._is_owned()
    old = SimpleNamespace(lock=threading.RLock())
    new = SimpleNamespace(lock=threading.RLock())
    dm.connection = old
    got = []
    old.lock.acquire()
    waiter = threading.Thread(target=lambda: got.append(
        _held_in_guard(dm, old, new)))
    waiter.start()
    time.sleep(0.2)
    assert not got
    dm.connection = new  # the connection changed while the guard waited
    old.lock.release()
    waiter.join(5.0)
    assert got == [(False, True)]


def _held_in_guard(dm, old, new) -> tuple:
    with dm.dispatch_guard():
        return old.lock._is_owned(), new.lock._is_owned()


def _catch_up_race(P):
    """A joiner connects to a doc whose history ends in a channel attach
    and an op on that channel; the writer edits as the joiner connects,
    so the joiner's reader thread gets live ops while its app thread
    holds in the runtime's processing of that attach during the
    connect-time catch-up. Returns (the errors raised while processing,
    by thread; whether the reader thread processed an op while the
    attach was held; the joiner's text at the end)."""
    server = P.LocalServer()
    local = P.LocalDocumentServiceFactory(server)
    writer = P.Loader(local).resolve("t", "catch-up")
    ds = writer.runtime.create_data_store("default")
    ds.create_channel("text", "shared-string").insert_text(0, "hi")
    assert writer.runtime.pending.count == 0

    factory = _ReaderFactory(local)
    errors = []
    reader_went = threading.Event()
    held = []

    def connect_then_edit(tenant, doc):
        svc = local.create_document_service(tenant, doc)

        class _Service:
            def connect_to_delta_stream(self, details=None):
                conn = _ReaderConnection(svc.connect_to_delta_stream(details))
                factory.conns.append(conn)
                writer.runtime.get_data_store("default").get_channel(
                    "text").insert_text(0, ">")
                return conn

            def __getattr__(self, name):
                return getattr(svc, name)

        return _Service()

    factory.create_document_service = connect_then_edit
    joiner = P.Loader(factory).resolve("t", "catch-up", connect=False)
    process = joiner.runtime.process

    def hooked(msg, local):
        thread = threading.current_thread().name
        if thread == "reader":
            reader_went.set()
        inner = (msg.contents or {}).get("contents") \
            if isinstance(msg.contents, dict) else None
        if thread != "reader" and isinstance(inner, dict) \
                and "attach" in inner:
            factory.conns[0].start_reader()
            held.append(reader_went.wait(0.5))
        try:
            process(msg, local)
        except Exception as e:
            errors.append((thread, f"{type(e).__name__}: {e}"))
            raise

    joiner.runtime.process = hooked
    try:
        joiner.connect()
    except Exception:
        pass  # recorded in errors
    deadline = time.monotonic() + 5.0
    text = None
    while time.monotonic() < deadline and not errors:
        store = joiner.runtime.data_stores.get("default")
        if store is not None and "text" in store.channels:
            text = store.get_channel("text").get_text()
            if text == ">hi":
                break
        time.sleep(0.01)
    factory.conns[0].close()
    return errors, held, text


def test_jax_catch_up_drains_beside_the_reader_thread():
    """The fault, in the JAX package's client stack: the reader thread
    processes the channel's op while the catch-up is inside its attach."""
    errors, held, _ = _catch_up_race(_pkg(ROOTS["jax"]))
    assert held == [True]
    assert errors[0] == (
        "reader", "KeyError: 'op for unknown channel text in store default'")


def test_port_catch_up_holds_the_dispatch_lock():
    """The repair: the reader thread waits for the catch-up, then
    delivers the live ops; the joiner reads the writer's text."""
    errors, held, text = _catch_up_race(_pkg(ROOTS["torch"]))
    assert held == [False] and errors == []
    assert text == ">hi"


def test_live_op_inside_the_handshake_range_is_overlap_not_duplicate():
    """A live op at or below the handshake's seq reaches the reader
    thread after the catch-up it waited for: it is dropped, as every
    already-processed op is, but not counted as a duplicate; one past the
    handshake's seq still counts."""
    from fluidframework_tpu_torch.driver.local import (
        LocalDocumentServiceFactory,
    )
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.service.local_server import LocalServer

    server = LocalServer()
    writer = Loader(LocalDocumentServiceFactory(server)).resolve("t", "ov")
    ds = writer.runtime.create_data_store("default")
    ds.create_channel("text", "shared-string").insert_text(0, "x")
    joiner = Loader(LocalDocumentServiceFactory(server)).resolve("t", "ov")
    dm = joiner.delta_manager
    handshake = dm._backfill_to
    assert handshake > 0 and dm.last_processed_seq > handshake
    history = dm._delta_storage.get_deltas(0, dm.last_processed_seq + 1)
    by_seq = {m.sequence_number: m for m in history}
    dm._enqueue(by_seq[handshake])
    assert dm.duplicates_received == 0
    dm._enqueue(by_seq[handshake + 1])
    assert dm.duplicates_received == 1
