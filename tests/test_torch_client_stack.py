"""The port's client stack against the JAX package's.

One seeded edit script runs through each package's ``Loader`` over its
``LocalServer`` (local driver, manual drain): three documents, two or
three containers a document, inserts, removes and annotates on a
SharedString, and a SharedMap in one document. The script goes in rounds
of one to three edits made concurrently (no delivery between them), then
a drain; after every round each container's ``state_fingerprint``
(protocol, runtime and sequence number; it needs every op acked) must be
the JAX package's. A ``SummaryManager`` summary then writes equal version
records and blob bytes, a late joiner boots from it, and everything the
two servers store is equal. Client ids carry a fixed epoch and the clock
stands at 0 on both sides, so the stores compare exactly.
"""

import random

import pytest

from tests.torch_stack_fixtures import stack, stored

DOCS = {"solo": 2, "trio": 3, "mapdoc": 2}  # doc → containers


def _edit(rng, tag: str, strings: dict, maps: dict) -> None:
    d = rng.choice(sorted(DOCS))
    i = rng.randrange(DOCS[d])
    s = strings[d][i]
    n = len(s.get_text())
    roll = rng.random()
    if d in maps and roll < 0.2:
        key = f"k{rng.randrange(3)}"
        if rng.random() < 0.25:
            maps[d][i].delete(key)
        else:
            maps[d][i].set(key, {"tag": tag, "v": rng.random()})
    elif roll < 0.55 or n < 2:
        props = {"bold": True} if rng.random() < 0.2 else None
        s.insert_text(rng.randrange(n + 1), f"<{tag}>", props)
    elif roll < 0.8:
        a = rng.randrange(n)
        s.remove_text(a, min(n, a + 1 + rng.randrange(4)))
    else:
        a = rng.randrange(n)
        s.annotate_range(a, min(n, a + 1 + rng.randrange(6)),
                         {"color": rng.choice(["red", None, 3])})


def _script(pkg: str, seed: int):
    """Run the edit script through one package; returns its stack, the
    fingerprints after each round, the server, the loader, and the
    containers and strings by doc."""
    st = stack(pkg)
    rng = random.Random(seed)
    server = st.server(auto_drain=False)
    loader = st.Loader(st.LocalDocumentServiceFactory(server))
    containers = {d: [loader.resolve("t", d) for _ in range(n)]
                  for d, n in DOCS.items()}
    server.drain()
    strings, maps = {}, {}
    for d, cs in containers.items():
        ds = cs[0].runtime.create_data_store("default")
        strings[d] = [ds.create_channel("text", "shared-string")]
        if d == "mapdoc":
            maps[d] = [ds.create_channel("kv", "shared-map")]
        server.drain()
        for c in cs[1:]:
            ds = c.runtime.get_data_store("default")
            strings[d].append(ds.get_channel("text"))
            if d == "mapdoc":
                maps[d].append(ds.get_channel("kv"))
        strings[d][0].insert_text(0, f"base of {d} ")
        server.drain()

    prints = []
    for step in range(40):
        # a round: one to three edits that are concurrent (no drain
        # between them), then everything is sequenced and delivered
        for k in range(rng.randint(1, 3)):
            _edit(rng, f"{step}.{k}", strings, maps)
        server.drain()
        prints.append([st.state_fingerprint(c) for cs in
                       containers.values() for c in cs])
    return st, prints, server, loader, containers, strings


@pytest.mark.parametrize("seed", [0, 5])
def test_fingerprints_equal_after_every_round(seed):
    _, want, _, _, _, jstrings = _script("jax", seed)
    _, got, _, _, containers, strings = _script("torch", seed)
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"round {step}"
    # and the containers of each doc converged on the JAX package's text
    for d in DOCS:
        assert {s.get_text() for s in strings[d]} \
            == {jstrings[d][0].get_text()}


def _summarized(pkg: str):
    st, _, server, loader, containers, strings = _script(pkg, 3)
    handles = {}
    for d, cs in containers.items():
        sm = st.SummaryManager(cs[0], max_ops=10**9)
        handles[d] = sm.summarize_now()
        server.drain()
        assert sm.summaries_acked == 1
    joiners = {d: loader.resolve("t", d, connect=False) for d in DOCS}
    return st, server, handles, joiners, strings


def test_summary_manager_writes_equal_versions_and_blobs():
    jst, jserver, jhandles, _, _ = _summarized("jax")
    st, server, handles, joiners, strings = _summarized("torch")
    assert handles == jhandles
    for d in DOCS:
        col = st.summary_versions_collection("t", d)
        versions = server.db.collection(col)
        assert versions == jserver.db.collection(
            jst.summary_versions_collection("t", d))
        assert versions[handles[d]]["acked"]
        # the version's tree, blob by blob
        storage, jstorage = server.storage("t", d), jserver.storage("t", d)
        tree_id = versions[handles[d]]["tree_id"]
        assert storage.read_blob(tree_id) == jstorage.read_blob(tree_id)
        assert storage.get_snapshot_tree() == jstorage.get_snapshot_tree()
        # a late joiner boots from the summary and holds the text
        j = joiners[d]
        assert j._base_snapshot is not None
        assert j.runtime.get_data_store("default").get_channel(
            "text").get_text() == strings[d][0].get_text()
    assert server.storage_stats == jserver.storage_stats
    assert stored(server) == stored(jserver)
