"""Seeded app documents: the shared-text DataObject of BASELINE config 1,
and a view of BASELINE config 3's matrix.

Each document is one ``DataObject`` made by a ``DataObjectFactory``: its
root ``SharedDirectory``, a ``shared-cell`` title, a ``shared-string``
body and a ``shared-counter`` of edits, as ``examples/shared_text.py``
builds its document. Its clients edit the body in rounds of concurrent
edits (each client one insert, remove or annotate a round, nothing
delivered until the round's end), then set the title and a root key and
increment the counter. The functions take the package's ``framework``
module and loader, so that a parity test runs the one script on the JAX
package and on the port; the smoke's ``apps`` phase runs it on the port.
``matrix_cells`` reads a ``SharedMatrix`` of either package as its
visible cells. (The JAX package has no counterpart module.)
"""

from __future__ import annotations

import random

APP_PKG = "shared-text"
DS_ID = "default"
BODY = "body"


def app_factory(framework):
    """The app's ``DataObjectFactory`` over a package's ``framework``."""

    class SharedTextApp(framework.DataObject):
        def initializing_first_time(self) -> None:
            self.create_channel("title", "shared-cell")
            self.create_channel(BODY, "shared-string")
            self.create_channel("edits", "shared-counter")
            self.get_channel("title").set("Untitled document")

    return framework.DataObjectFactory(APP_PKG, SharedTextApp)


def open_app_docs(loader, factory, tenant: str, docs: list,
                  clients: int = 2) -> dict:
    """{doc: [(container, app object)] a client}: the first client of
    each doc creates its DataObject, the others load it. The server must
    deliver as it sequences (auto drain) while the docs open."""
    out = {}
    for doc in docs:
        containers = [loader.resolve(tenant, doc) for _ in range(clients)]
        out[doc] = [(c, factory.create_or_load(c)) for c in containers]
    return out


def _body_edit(body, rng: random.Random, tag: str) -> None:
    n = len(body.get_text())
    roll = rng.random()
    if roll < 0.5 or n < 4:
        props = {"bold": True} if rng.random() < 0.2 else None
        body.insert_text(rng.randrange(n + 1), f"{tag} ", props)
    elif roll < 0.8:
        a = rng.randrange(n - 1)
        body.remove_text(a, min(n, a + 1 + rng.randrange(3)))
    else:
        a = rng.randrange(n - 1)
        body.annotate_range(a, min(n, a + 1 + rng.randrange(6)),
                            {"style": rng.randrange(4)})


def edit_app_docs(server, apps: dict, rounds: int, seed: int,
                  after_round=None) -> int:
    """Run the seeded edit script on every doc and return the ops
    submitted. Each round every client makes one body edit and nothing
    is delivered until the round's end; a last round sets the title
    (first client), a root key (last client) and increments the counter
    (every client). ``after_round()`` runs after each round's delivery
    (a replica farm ingests there). Delivery is manual during the script
    and automatic again after it."""
    rng = random.Random(seed)
    ops = 0
    server._auto_drain = False
    try:
        for r in range(rounds):
            for doc, clients in apps.items():
                for i, (_, obj) in enumerate(clients):
                    _body_edit(obj.get_channel(BODY), rng, f"r{r}c{i}")
                    ops += 1
            server.drain()
            if after_round is not None:
                after_round()
        for doc, clients in apps.items():
            clients[0][1].get_channel("title").set(f"{doc}: notes")
            clients[-1][1].root.set("owner", f"client {len(clients) - 1}")
            for i, (_, obj) in enumerate(clients):
                obj.get_channel("edits").increment(i + 1)
            ops += 2 + len(clients)
        server.drain()
        if after_round is not None:
            after_round()
    finally:
        server._auto_drain = True
    return ops


def app_view(obj) -> dict:
    """What a reader of one app object sees: title, root key, counter and
    body text."""
    return {"title": obj.get_channel("title").get(),
            "owner": obj.root.get("owner"),
            "edits": obj.get_channel("edits").value,
            "body": obj.get_channel(BODY).get_text()}


def feed_bodies(server, applier, tenant: str, docs: list,
                channel_stream) -> int:
    """Ingest every doc's body ops that ``applier`` has not applied
    (``channel_stream`` is the package's, from the applier's seq on);
    returns the ops ingested."""
    n = 0
    for doc in docs:
        pairs = [(m, m.contents) for m in channel_stream(
            server, tenant, doc, DS_ID, BODY,
            from_seq=applier.applied_seq(tenant, doc))]
        if pairs:
            applier.ingest_batch(tenant, doc, pairs)
            n += len(pairs)
    return n


def matrix_cells(m) -> list:
    """A matrix's shape and every visible cell as ``[row, col, value]``,
    sorted by position: what ``to_lists`` holds, without its walk of the
    merge tree a cell."""
    cells = []
    for (rh, ch), v in m._cells.items():
        at = m.position_of_handles(rh, ch)
        if at is not None:
            cells.append([at[0], at[1], v])
    return [m.row_count, m.col_count, sorted(cells, key=lambda c: c[:2])]
