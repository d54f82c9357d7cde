"""Doc history plane: commit/ref graph, fork, time-travel, integrate.

JAX counterpart: ``fluidframework_tpu/service/history_plane.py``; the
port's copy, imports rebased to this package. The port's ``LocalServer``
has no storage directory, so the records always live in the db sink:
``RefLog`` files under ``<storage_dir>/history`` come with the storage
tier (ROADMAP A9), and so does the storage process the fork refuses.

The reference protocol reserves ``fork``/``integrate`` MessageTypes it
never implements and models every summary as a git commit with refs
(gitrest). This plane builds that capability on a strictly better
substrate: content-addressed snapcols chunks (cross-generation dedupe)
plus the seq-indexed durable op log.

**Commit graph.** Every service-summarizer commit lands here as a
history commit ``{id, version, base_seq, parents, chunk_ids, ts}`` —
``version`` is the storage version handle (``vN``), ``base_seq`` its
capture seq, ``chunk_ids`` the content-addressed chunks the generation
references. **Refs** are named branch heads: ``refs/main`` follows the
doc's own summary chain; ``fork/<tenant>/<doc>`` on a PARENT pins the
commit a fork was cut from (the retention contract below). Records
persist per-doc in the db as torn-tail-tolerant framed records
(protocol/refgraph.py), so in-proc orderer restarts still recover.

**Fork** (``fork(tenant, doc, at_seq) -> new doc``) is O(snapshot)
bytes ≈ 0: the fork's v0 version record re-references the parent's root
blob and chunks verbatim (content-addressed, same store), the parent's
post-snapshot tail ``(B, at_seq]`` is adopted — already sequenced —
onto the fork's deltas topic, and deli/scribe/scriptorium checkpoints
are seeded so the fork's pipeline boots at ``at_seq`` exactly as if it
had lived the parent's history. Summarize-family ops in the tail ride
as NOOPs (their handles reference the parent's version chain). Clients
then boot the fork through the ordinary snapshot+bounded-backfill door.

**Time-travel** resolves any historical ``(doc, seq)`` to the nearest
commit at-or-below plus the bounded tail — served read-only through the
normal front_end doors riding read-only sessions (no join op, no quorum
seat); the driver side is driver/history.py ``open_at``.

**Integrate** replays a fork's post-base tail onto the parent through
the ordinary total order: a normal write connection submits the fork's
chanops as fresh client ops (refSeq = join head, which the integrating
client's own presence pins above the msn), so merge semantics come from
the CRDT — no new merge machinery. With a quiet parent the result is
the fork's exact text; with concurrent parent writers it is whatever
the merge tree converges to, identically on every replica.

**Chunk GC / retention pinning.** Scriptorium op-retention is per-doc
and unaffected by forks (the fork copies the tail it needs at fork
time). CHUNK retention is cross-doc: chunks are content-addressed and
shared, so the GC ref-counts across the commit graph — a chunk is live
iff some REF-REACHABLE head (any doc's branch head, any fork pin)
names it; only chunks named by superseded commits of scanned docs are
candidates. Trimming a parent can therefore never unlink blobs a live
fork still boots from.

**Crash atomicity.** Fork writes its commit record first, seeds the new
doc, then flips the refs (pin on the parent, ``refs/main`` on the
fork). A crash in between leaves a *pending* commit and possibly a torn
ref-file tail — recovery (on next load) adopts the fork iff its seeding
reached the durable versions topic, else discards it, atomically in
both directions; a dangling ref is impossible because refs are written
last and a torn ref record is dropped by CRC.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Optional

from ..obs import get_journal, tier_counters
from ..protocol import refgraph
from ..protocol.messages import DocumentMessage, MessageType
from ..utils.affinity import any_thread, loop_only
from .core import summary_versions_collection
from .local_orderer import CHECKPOINT_COLLECTION
from .scribe import SCRIBE_CHECKPOINT_COLLECTION
from .scriptorium import LogTruncatedError

#: ops whose contents reference the PARENT's summary chain — they ride
#: a fork's adopted tail as NOOPs (same seq/msn: the dense invariant
#: and the msn schedule must survive the adoption byte-for-byte)
_SUMMARY_TYPES = (MessageType.SUMMARIZE, MessageType.SUMMARY_ACK,
                  MessageType.SUMMARY_NACK)

MAIN_REF = "refs/main"


def fork_pin_ref(tenant_id: str, document_id: str) -> str:
    """The ref name on a PARENT pinning the commit a fork was cut from."""
    return f"fork/{tenant_id}/{document_id}"


class _DbRecords:
    """Record sink/source in the server db: survives in-proc orderer
    restarts; dies with the process like the rest of the db."""

    def __init__(self, db, col: str):
        self._db = db
        self._col = col

    def load(self) -> list[dict]:
        col = self._db.collection(self._col)
        out = []
        for i in range(len(col)):
            rec = col.get(str(i))
            if rec is None:
                break
            records, _ = refgraph.scan_records(bytes.fromhex(rec["hex"]))
            out.extend(records)
        return out

    def append(self, *payloads: bytes) -> None:
        col = self._db.collection(self._col)
        n = len(col)
        data = b"".join(refgraph.frame_record(p) for p in payloads)
        self._db.upsert(self._col, str(n), {"hex": data.hex()})


class _DocHistory:
    """One doc's loaded commit graph + refs (fold of the record file)."""

    __slots__ = ("records", "commits", "refs", "discarded")

    def __init__(self, sink, records: list[dict]):
        self.records = sink
        self.commits, self.refs, self.discarded = \
            refgraph.replay_records(records)

    def head(self, ref: str = MAIN_REF) -> Optional[dict]:
        cid = self.refs.get(ref)
        return self.commits.get(cid) if cid else None

    def reachable_heads(self) -> list[dict]:
        """Commits some ref points AT (heads only — ancestry does not
        pin chunks; superseded generations are the GC's candidates)."""
        out = []
        for cid in set(self.refs.values()):
            c = self.commits.get(cid)
            if c is not None:
                out.append(c)
        return out


class HistoryPlane:
    """Per-server history service over the commit/ref graph."""

    #: chaos seam (``chaos/`` of this package): crash directives at
    #: ``history.fork`` with ``stage`` = ``commit`` (commit record
    #: written, doc not seeded) or ``seeded`` (doc seeded, refs not yet
    #: flipped) tear the fork mid-flight; recovery must adopt-or-discard
    fault_plane = None

    def __init__(self, server):
        self.server = server
        self.counters = tier_counters("service")
        self._docs: dict = {}

    # ------------------------------------------------------------ store

    def _sink(self, tenant_id: str, document_id: str):
        return _DbRecords(self.server.db,
                          f"history-records/{tenant_id}/{document_id}")

    @any_thread
    def _store(self, tenant_id: str, document_id: str) -> _DocHistory:
        key = (tenant_id, document_id)
        doc = self._docs.get(key)
        if doc is None:
            sink = self._sink(tenant_id, document_id)
            doc = _DocHistory(sink, sink.load())
            self._docs[key] = doc
            self._recover(tenant_id, document_id, doc)
        return doc

    def _append(self, doc: _DocHistory, *payloads: bytes) -> None:
        doc.records.append(*payloads)

    def _add_commit(self, doc: _DocHistory, commit: dict) -> None:
        doc.commits[commit["id"]] = commit

    def _set_ref(self, doc: _DocHistory, name: str,
                 commit_id: Optional[str]) -> None:
        if commit_id is None:
            doc.refs.pop(name, None)
        else:
            doc.refs[name] = commit_id

    # --------------------------------------------------------- recovery

    def _recover(self, tenant_id: str, document_id: str,
                 doc: _DocHistory) -> None:
        """Adopt-or-discard pending fork commits (crash mid-fork).

        A *pending* commit is a fork-origin commit no ref covers and no
        discard marker abandons. Adoption requires the fork's seeding to
        have reached the durable versions topic (the v0 record is the
        fork's boot source — without it the doc does not exist); then
        the missing refs are written. Otherwise a discard marker is
        appended and any half-written parent pin is deleted — either
        way the graph is consistent and no ref dangles."""
        covered = set(doc.refs.values())
        for cid, commit in list(doc.commits.items()):
            origin = (commit.get("extra") or {}).get("fork_of")
            if origin is None or cid in covered or cid in doc.discarded:
                continue
            seeded = False
            try:
                topic = f"versions/{tenant_id}/{document_id}"
                seeded = self.server.log.length(topic) > 0
            except Exception:
                seeded = False
            journal = get_journal()
            if seeded:
                pins = [refgraph.encode_ref(MAIN_REF, cid, ts=time.time())]
                self._append(doc, *pins)
                self._set_ref(doc, MAIN_REF, cid)
                pdoc = self._store(origin["tenant"], origin["doc"])
                pin = fork_pin_ref(tenant_id, document_id)
                if pin not in pdoc.refs:
                    self._append(pdoc, refgraph.encode_ref(
                        pin, commit["parents"][0], ts=time.time()))
                    self._set_ref(pdoc, pin, commit["parents"][0])
                action = "adopt"
            else:
                self._append(doc, refgraph.encode_discard(cid))
                doc.discarded.add(cid)
                pdoc = self._store(origin["tenant"], origin["doc"])
                pin = fork_pin_ref(tenant_id, document_id)
                if pin in pdoc.refs:
                    self._append(pdoc, refgraph.encode_ref(pin, None))
                    self._set_ref(pdoc, pin, None)
                action = "discard"
            journal.emit("history.ref.recover", tenant=tenant_id,
                         doc=document_id, commit=cid, action=action)
            self.counters.inc("history.ref.recovered")

    # ----------------------------------------------------------- commits

    @any_thread
    def record_commit(self, tenant_id: str, document_id: str,
                      version_id: str, base_seq: int,
                      chunk_ids: list, parents: Optional[list] = None,
                      extra: Optional[dict] = None,
                      ref: str = MAIN_REF) -> dict:
        """Record one summary generation as a commit and advance ``ref``
        to it — the summarizer's commit hook and the fork path both land
        here (the single graph-update path, like scribe.commit_version
        is for versions)."""
        doc = self._store(tenant_id, document_id)
        if parents is None:
            head = doc.head(ref)
            parents = [head["id"]] if head else []
        commit = {
            "id": self._commit_id(tenant_id, document_id, version_id,
                                  base_seq),
            "version": version_id,
            "base_seq": int(base_seq),
            "parents": list(parents),
            "chunk_ids": list(chunk_ids),
            "ts": time.time(),
            "extra": dict(extra or {}),
        }
        self._append(doc, refgraph.encode_commit(commit),
                     refgraph.encode_ref(ref, commit["id"],
                                         ts=commit["ts"]))
        self._add_commit(doc, commit)
        self._set_ref(doc, ref, commit["id"])
        self.counters.inc("history.commit.records")
        get_journal().emit("history.commit", tenant=tenant_id,
                           doc=document_id, version=version_id,
                           seq=base_seq)
        return commit

    @staticmethod
    def _commit_id(tenant_id: str, document_id: str, version_id: str,
                   base_seq: int) -> str:
        import hashlib

        return hashlib.sha256(
            f"{tenant_id}/{document_id}/{version_id}@{base_seq}".encode()
        ).hexdigest()[:16]

    @any_thread
    def log(self, tenant_id: str, document_id: str,
            count: Optional[int] = None) -> list[dict]:
        """Commits newest-first (the ``history log`` listing), seeded
        lazily from pre-plane acked snapcols versions on first touch."""
        doc = self._ensure_seeded(tenant_id, document_id)
        commits = sorted(doc.commits.values(),
                         key=lambda c: (c["base_seq"], c["ts"]),
                         reverse=True)
        commits = [c for c in commits if c["id"] not in doc.discarded]
        return commits[:count] if count else commits

    @any_thread
    def refs(self, tenant_id: str, document_id: str) -> dict:
        return dict(self._store(tenant_id, document_id).refs)

    @any_thread
    def commit_at(self, tenant_id: str, document_id: str,
                  seq: int) -> Optional[dict]:
        """Nearest commit with ``base_seq <= seq`` (the snapshot a
        time-travel read or fork boots from)."""
        best = None
        for c in self.log(tenant_id, document_id):
            if c["base_seq"] <= seq and (
                    best is None or c["base_seq"] > best["base_seq"]):
                best = c
        return best

    def _ensure_seeded(self, tenant_id: str, document_id: str) -> _DocHistory:
        """Backfill the graph from already-acked snapcols versions the
        summarizer committed before the plane existed (or before this
        server restart in db mode) — history must not start at 'now'."""
        doc = self._store(tenant_id, document_id)
        if doc.commits:
            return doc
        try:
            storage = self.server.storage(tenant_id, document_id)
            versions = storage.get_versions(1000)
        except Exception:
            return doc
        for v in reversed(versions):  # oldest first: parents chain up
            try:
                root = json.loads(storage.read_blob(v["tree_id"]).decode())
            except Exception:
                continue
            if root.get("t") != "snapcols":
                continue
            self.record_commit(tenant_id, document_id, v["id"],
                               root.get("sequence_number", 0),
                               root.get("chunks", ()))
        return doc

    # ------------------------------------------------------ delta reads

    @any_thread
    def read_deltas(self, tenant_id: str, document_id: str,
                    from_seq: int, to_seq: int) -> list:
        """Historical ops ``from_seq < seq < to_seq`` — scriptorium
        first; when retention trimmed below the range, fall back to a
        scan of the durable deltas topic from offset 0 (append-only:
        trimmed seqs are still physically present). History reads are
        *explicitly* historical, so the retention contract that protects
        live boots does not apply here."""
        orderer = self.server._get_orderer(tenant_id, document_id)
        try:
            return orderer.scriptorium.get_deltas(
                tenant_id, document_id, from_seq, to_seq)
        except LogTruncatedError:
            self.counters.inc("history.replay.log_scans")
            return self._scan_log(tenant_id, document_id, from_seq, to_seq)

    def _scan_log(self, tenant_id: str, document_id: str,
                  from_seq: int, to_seq: int) -> list:
        log = self.server.log
        topic = f"deltas/{tenant_id}/{document_id}"
        out: dict[int, object] = {}
        try:
            n = log.length(topic)
        except Exception:
            return []
        for i in range(n):
            rec = log.read(topic, i)
            msgs = None
            if isinstance(rec, dict):
                abatch = rec.get("abatch")
                if abatch is not None:
                    msgs = abatch.messages()
                else:
                    msgs = rec.get("boxcar") or [rec["message"]]
            if not msgs:
                continue
            for m in msgs:
                s = m.sequence_number
                if from_seq < s < to_seq:
                    out[s] = m  # crash-replay overlap: last write wins
        return [out[s] for s in sorted(out)]

    @any_thread
    def replay_read(self, tenant_id: str, document_id: str,
                    seq: int) -> dict:
        """Resolve a time-travel read: the commit to boot from plus its
        version/tree binding (the driver's ``open_at`` consumes this)."""
        commit = self.commit_at(tenant_id, document_id, seq)
        if commit is None:
            raise ValueError(
                f"no committed version at or below seq {seq} for "
                f"{tenant_id}/{document_id} (summarize first)")
        rec = self.server.db.find_one(
            summary_versions_collection(tenant_id, document_id),
            commit["version"])
        if rec is None:
            raise ValueError(f"version {commit['version']} record missing")
        self.counters.inc("history.replay.reads")
        return {"commit": refgraph.commit_to_json(commit),
                "version": {"id": commit["version"],
                            "tree_id": rec["tree_id"]},
                "base_seq": commit["base_seq"]}

    # -------------------------------------------------------------- fork

    @loop_only("core")
    def fork(self, tenant_id: str, document_id: str,
             at_seq: Optional[int] = None,
             new_doc: Optional[str] = None) -> dict:
        """Fork ``document_id`` at ``at_seq`` into ``new_doc``.

        Boots O(snapshot): the fork's v0 re-references the parent's root
        blob and chunks (content-addressed — zero new blob bytes on the
        same store), the already-sequenced tail ``(B, at_seq]`` is
        adopted verbatim onto the fork's topics, and the fork's pipeline
        checkpoints are seeded at ``at_seq``. Runs on the core loop:
        every mutation is new-doc-local except the parent tail read and
        the ref-file appends."""
        server = self.server
        orderer = server._get_orderer(tenant_id, document_id)
        head = orderer.deli.sequence_number
        if at_seq is None:
            at_seq = head
        if at_seq > head:
            raise ValueError(f"fork seq {at_seq} is beyond head {head}")
        if getattr(server, "_storage_conn", None) is not None:
            raise ValueError(
                "fork over a storage-process deployment is not supported "
                "yet: the fork's v0 record must land in the storage "
                "server's version chain")
        commit = self.commit_at(tenant_id, document_id, at_seq)
        if commit is None:
            raise ValueError(
                f"no committed version at or below seq {at_seq} for "
                f"{tenant_id}/{document_id} (summarize first)")
        base = commit["base_seq"]
        if new_doc is None:
            new_doc = f"{document_id}-fork-{uuid.uuid4().hex[:8]}"
        self._check_fork_target(tenant_id, new_doc)

        parent_rec = server.db.find_one(
            summary_versions_collection(tenant_id, document_id),
            commit["version"])
        if parent_rec is None:
            raise ValueError(f"version {commit['version']} record missing")
        tree_id = parent_rec["tree_id"]
        root = json.loads(server.blob_store.get(tree_id).decode())
        tail = self.read_deltas(tenant_id, document_id, base, at_seq + 1)

        # 1) pending fork commit — crash after this point must leave a
        #    recoverable graph (no ref flips yet)
        fdoc = self._store(tenant_id, new_doc)
        fork_commit = {
            "id": self._commit_id(tenant_id, new_doc, "v0", base),
            "version": "v0",
            "base_seq": base,
            "parents": [commit["id"]],
            "chunk_ids": list(commit["chunk_ids"]),
            "ts": time.time(),
            "extra": {"fork_of": {"tenant": tenant_id, "doc": document_id,
                                  "seq": at_seq}},
        }
        self._append(fdoc, refgraph.encode_commit(fork_commit))
        self._add_commit(fdoc, fork_commit)
        self._chaos("history.fork", stage="commit", tenant=tenant_id,
                    doc=new_doc)

        # 2) seed the fork doc: version record + topics + checkpoints —
        #    all before any orderer exists for it, so construction
        #    rebuilds a consistent pipeline from these alone
        self._seed_fork(tenant_id, document_id, new_doc, root, tree_id,
                        base, at_seq, tail)
        self._chaos("history.fork", stage="seeded", tenant=tenant_id,
                    doc=new_doc)

        # 3) flip the refs: pin on the parent first (a live fork must
        #    never exist unpinned), then the fork's own head
        pdoc = self._store(tenant_id, document_id)
        pin = fork_pin_ref(tenant_id, new_doc)
        self._append(pdoc, refgraph.encode_ref(pin, commit["id"],
                                               ts=time.time()))
        self._set_ref(pdoc, pin, commit["id"])
        self._append(fdoc, refgraph.encode_ref(MAIN_REF, fork_commit["id"],
                                               ts=time.time()))
        self._set_ref(fdoc, MAIN_REF, fork_commit["id"])

        # 4) construct the fork's pipeline now: surfaces any seeding
        #    error at fork time and delivers the adopted tail
        forderer = server._get_orderer(tenant_id, new_doc)
        self._pump_doc(tenant_id, new_doc)

        self.counters.inc("history.fork.boots")
        self.counters.inc("history.fork.tail_ops", len(tail))
        get_journal().emit("history.fork", tenant=tenant_id,
                           doc=document_id, fork=new_doc, seq=at_seq,
                           base=base)
        return {"doc": new_doc, "parent": document_id,
                "base_seq": base, "fork_seq": at_seq,
                "version": commit["version"],
                "commit": fork_commit["id"],
                "shared_chunks": len(commit["chunk_ids"]),
                "tail_ops": len(tail),
                "head": forderer.deli.sequence_number}

    def _check_fork_target(self, tenant_id: str, new_doc: str) -> None:
        server = self.server
        if f"{tenant_id}/{new_doc}" in server._orderers:
            raise ValueError(f"fork target {new_doc!r} already exists")
        if server.db.collection(
                summary_versions_collection(tenant_id, new_doc)):
            raise ValueError(f"fork target {new_doc!r} already exists")
        try:
            if server.log.length(f"deltas/{tenant_id}/{new_doc}") > 0:
                raise ValueError(f"fork target {new_doc!r} already exists")
        except ValueError:
            raise
        except Exception:
            pass  # topic does not exist yet: good

    def _seed_fork(self, tenant_id: str, parent: str, new_doc: str,
                   root: dict, tree_id: str, base: int, at_seq: int,
                   tail: list) -> None:
        import dataclasses

        server = self.server
        # v0 version record: the parent's root blob verbatim — the
        # content-addressed chunks make this the whole O(snapshot) story
        rec = {"n": 0, "tree_id": tree_id, "parent": None,
               "acked": True, "seq": base, "_id": "v0"}
        server.db.upsert(summary_versions_collection(tenant_id, new_doc),
                         "v0", rec)
        server.log.append(f"versions/{tenant_id}/{new_doc}",
                          {"handle": "v0", "version": dict(rec)})
        # adopted tail rides the fork's deltas topic already-sequenced;
        # summarize-family ops neutralize to NOOPs (their handles
        # reference the parent's version chain), same seq/msn so the
        # dense invariant and msn schedule are preserved
        topic = f"deltas/{tenant_id}/{new_doc}"
        for m in tail:
            if m.type in _SUMMARY_TYPES:
                m = dataclasses.replace(m, type=MessageType.NOOP,
                                        contents=None)
            server.log.append(topic, {"tenant_id": tenant_id,
                                      "document_id": new_doc,
                                      "message": m})
        # pipeline checkpoints: deli at at_seq with an empty client table
        # (msn rides the seq until the first join), scribe's protocol at
        # the snapshot — its deltas-topic replay advances it over the
        # adopted tail (offset gate at -1 admits everything)
        key = f"{tenant_id}/{new_doc}"
        deli_state = {"log_offset": -1, "sequence_number": at_seq,
                      "clients": []}
        scribe_state = {"protocol": dict(root["protocol"]), "head": "v0",
                        "offset": -1}
        server.db.upsert(CHECKPOINT_COLLECTION, key, {"state": deli_state})
        server.db.upsert(SCRIBE_CHECKPOINT_COLLECTION, key,
                         {"state": scribe_state})
        # checkpoint-topic record: after full process death the db is
        # gone — the durable log must rebuild the same pipeline state
        server.log.append(f"checkpoints/{tenant_id}/{new_doc}",
                          {"deli": dict(deli_state),
                           "scribe": dict(scribe_state),
                           "scriptorium_base": base})

    def _pump_doc(self, tenant_id: str, document_id: str) -> None:
        """Deliver the doc's own queued topic records without draining
        the whole log (auto_drain=False tests keep their interleaving
        control over OTHER docs)."""
        log = self.server.log
        for topic in (f"deltas/{tenant_id}/{document_id}",
                      f"rawops/{tenant_id}/{document_id}"):
            try:
                while log.step(topic):
                    pass
            except Exception:
                break

    def _chaos(self, point: str, **ctx) -> None:
        plane = self.fault_plane
        if plane is not None:
            plane(point, **ctx)

    # --------------------------------------------------------- integrate

    @loop_only("core")
    def integrate(self, tenant_id: str, fork_doc: str,
                  batch: int = 64) -> dict:
        """Replay the fork's post-base tail onto its parent through the
        ordinary total order.

        A normal write connection joins the parent (its presence pins
        the msn at the join head), then submits the fork's chanops as
        fresh client ops with refSeq = join head. The CRDT does the
        merging: against a quiet parent this reproduces the fork's text
        exactly; against concurrent writers every replica converges to
        the same merge. Seal/revoke fencing and deli admission apply
        exactly as for any client — no side door into the log."""
        fstore = self._store(tenant_id, fork_doc)
        origin = None
        for c in fstore.commits.values():
            o = (c.get("extra") or {}).get("fork_of")
            if o is not None and c["id"] not in fstore.discarded:
                origin = o
                break
        if origin is None:
            raise ValueError(f"{fork_doc!r} is not a fork")
        parent, fork_seq = origin["doc"], origin["seq"]
        forderer = self.server._get_orderer(tenant_id, fork_doc)
        fork_head = forderer.deli.sequence_number
        tail = self.read_deltas(tenant_id, fork_doc, fork_seq,
                                fork_head + 1)
        envs = [m.contents for m in tail
                if m.type == MessageType.OPERATION
                and isinstance(m.contents, dict)
                and m.contents.get("kind") == "chanop"]
        conn = self.server.connect(tenant_id, parent,
                                   details={"integrate": fork_doc})
        try:
            # make sure the join is ticketed, then anchor refSeq at the
            # client's OWN post-join reference seq: the table entry pins
            # the msn at-or-below it, so these ops can never refSeq-nack
            # (the handshake seq alone could be stale if other clients'
            # queued records sequenced between capture and the join)
            self._pump_doc(tenant_id, parent)
            porderer = self.server._get_orderer(tenant_id, parent)
            cstate = porderer.deli.clients.get(conn.client_id)
            ref = (cstate.reference_sequence_number if cstate is not None
                   else conn.initial_sequence_number)
            msgs = [DocumentMessage(client_sequence_number=i + 1,
                                    reference_sequence_number=ref,
                                    type=MessageType.OPERATION,
                                    contents=env)
                    for i, env in enumerate(envs)]
            for i in range(0, len(msgs), batch):
                conn.submit(msgs[i:i + batch])
        finally:
            conn.disconnect()
        self.counters.inc("history.integrate.sessions")
        self.counters.inc("history.integrate.ops", len(envs))
        get_journal().emit("history.integrate", tenant=tenant_id,
                           doc=parent, fork=fork_doc, ops=len(envs),
                           fork_seq=fork_seq)
        return {"parent": parent, "fork": fork_doc, "ops": len(envs),
                "fork_seq": fork_seq, "fork_head": fork_head}

    # -------------------------------------------------------------- GC

    @any_thread
    def pinned_chunks(self, tenant_id: str, document_id: str) -> set:
        """Chunks any ref-reachable head of this doc still names."""
        doc = self._ensure_seeded(tenant_id, document_id)
        live: set = set()
        for c in doc.reachable_heads():
            live.update(c["chunk_ids"])
        return live

    @loop_only("core")
    def gc_chunks(self, tenant_id: str,
                  documents: Optional[list] = None) -> dict:
        """Sweep snapshot chunks no ref-reachable head names.

        Liveness ref-counts across the WHOLE commit graph: every scanned
        doc's branch heads AND every fork pin contribute — so trimming a
        parent whose old generation a live fork still boots from deletes
        nothing that fork needs (the pin holds its commit's chunks). The
        candidate set is restricted to chunks some commit of a scanned
        doc ever named: the blob store also holds roots, tree nodes and
        legacy blobs the graph knows nothing about, and those are never
        touched."""
        if documents is None:
            documents = sorted({d for (t, d) in self._docs
                                if t == tenant_id})
        live: set = set()
        candidates: set = set()
        roots: set = set()
        for d in documents:
            doc = self._ensure_seeded(tenant_id, d)
            for c in doc.commits.values():
                candidates.update(c["chunk_ids"])
            for c in doc.reachable_heads():
                live.update(c["chunk_ids"])
            # the root blob of every ref-reachable head stays too
            for c in doc.reachable_heads():
                rec = self.server.db.find_one(
                    summary_versions_collection(tenant_id, d), c["version"])
                if rec is not None:
                    roots.add(rec["tree_id"])
        store = self.server.blob_store
        delete = getattr(store, "delete", None)
        swept = 0
        dead = candidates - live - roots
        if delete is not None:
            for cid in sorted(dead):
                if delete(cid):
                    swept += 1
        self.counters.inc("history.gc.scanned", len(candidates))
        self.counters.inc("history.gc.pinned", len(live))
        self.counters.inc("history.gc.deleted", swept)
        get_journal().emit("history.gc", tenant=tenant_id,
                           scanned=len(candidates), pinned=len(live),
                           deleted=swept)
        return {"scanned": len(candidates), "pinned": len(live),
                "deleted": swept}
