"""Service-generated summaries from the replica farm's device state.

JAX counterpart: ``fluidframework_tpu/service/service_summarizer.py``;
the port's copy, imports rebased to this package. Version records,
blobs, the scribe head and the history-plane commit each summary records
are the JAX package's.

Ref: scribe's writeServiceSummary (scribe/summaryWriter.ts:226) — the
reference's server can persist a service summary without any client
summarizer, but must REPLAY the op log in JS to get content. Here the
GpuDocumentApplier already holds every doc's converged merge-tree on
device, so a service summary is a decode + upload: the scribe-replay
batch pass of BASELINE config 5, productized.

Two layers on top of the one-shot decode+upload:

- **Columnar content-addressed storage**: the merge-tree snapshot is
  encoded as packed snapcols chunks (protocol/snapcols.py), each chunk
  a content-addressed blob. Unchanged chunks hash identically across
  summary generations and are NOT re-uploaded
  (``storage.snapshot.chunks_reused``); an incremental summary ships
  only the changed tail. The version's root blob is a small "snapcols"
  record naming the chunk hashes plus the protocol state.
- **Threshold-driven loop**: with ``ops_per_summary`` set, ``run_pass``
  summarizes every doc whose stream advanced ≥ N ops since its last
  summary — the serving side of the snapshot fast-boot plane (a late
  joiner's backfill is then O(snapshot + Δ), never O(whole log)).

Scope (by design): the device models merge-tree channels. Documents
whose data stores hold ONLY device-modeled channels get full service
summaries; anything else must keep client summaries — the summarizer
refuses rather than writing a summary that would boot clients into
truncated state.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from ..obs import tier_counters
from ..protocol import snapcols

DS_ID = "default"
TEXT_CHANNEL = "text"

#: root-record marker distinguishing columnar summaries from legacy
#: monolithic dicts and client summary trees
SNAPCOLS_KIND = "snapcols"


def snapcols_root(snap: dict, chunk_ids: list, protocol: dict,
                  sequence_number: int, pkg: str, ds_id: str,
                  channel_id: str) -> dict:
    """The version root record: everything a boot needs EXCEPT the chunk
    bytes themselves (which are content-addressed siblings)."""
    return {
        "t": SNAPCOLS_KIND,
        "v": snapcols.SNAPCOLS_VER,
        "chunks": list(chunk_ids),
        "tree_seq": snap["seq"],
        "min_seq": snap["minSeq"],
        "protocol": protocol,
        "sequence_number": sequence_number,
        "pkg": pkg,
        "ds": ds_id,
        "channel": channel_id,
    }


class HostReplicaSource:
    """Applier-duck-typed content source for deployments without a
    device applier (the socket front end's summarize loop): persistent
    host-side merge-tree replicas fed incrementally from the sequenced
    log — the reference's scribe-replay, kept warm so each summary pays
    only the delta since the last one.

    Coverage story: replicas ingest from seq 0 while the log is whole,
    so the summarizer gate's from-genesis check passes; after the first
    committed summary anchors the doc, retention may trim and the
    replica keeps advancing incrementally (its state already covers the
    trimmed prefix)."""

    def __init__(self, server, ds_id: str = DS_ID,
                 channel_id: str = TEXT_CHANNEL):
        self.server = server
        self.ds_id = ds_id
        self.channel_id = channel_id
        self._replicas: dict = {}
        self._applied: dict = {}
        self._first: dict = {}
        self._anchored: set = set()

    def _ingest(self, tenant_id: str, document_id: str):
        from ..mergetree.client import MergeTreeClient
        from .scriptorium import channel_stream

        key = (tenant_id, document_id)
        replica = self._replicas.get(key)
        if replica is None:
            replica = self._replicas[key] = MergeTreeClient(
                f"svc-summarizer/{tenant_id}/{document_id}")
        for m in channel_stream(self.server, tenant_id, document_id,
                                self.ds_id, self.channel_id,
                                from_seq=self._applied.get(key, 0)):
            if m.sequence_number <= self._applied.get(key, 0):
                continue
            replica.apply_msg(m, local=False)
            self._applied[key] = m.sequence_number
            self._first.setdefault(key, m.sequence_number)
        return replica

    # ---- the applier surface the summarizer consumes ----
    def get_tree(self, tenant_id: str, document_id: str):
        return self._ingest(tenant_id, document_id)

    def applied_seq(self, tenant_id: str, document_id: str) -> int:
        self._ingest(tenant_id, document_id)
        return self._applied.get((tenant_id, document_id), 0)

    def first_seq(self, tenant_id: str, document_id: str) -> int:
        return self._first.get((tenant_id, document_id), 0)

    def is_anchored(self, tenant_id: str, document_id: str) -> bool:
        return (tenant_id, document_id) in self._anchored

    def mark_anchored(self, tenant_id: str, document_id: str) -> None:
        self._anchored.add((tenant_id, document_id))

    def restore_gap(self, tenant_id: str, document_id: str):
        return None  # host replicas never restore from a checkpoint

    def finalize(self) -> None:
        pass  # no device fence


class ServiceSummarizer:
    """Writes acked summaries straight from the applier's device state."""

    #: chaos seam (fluidframework_tpu/chaos): a crash directive at
    #: ``snapshot.upload`` kills the summarizer after the chunk upload
    #: but before the scribe commit — the mid-upload crash window
    fault_plane = None

    def __init__(self, server, applier, ds_id: str = DS_ID,
                 channel_id: str = TEXT_CHANNEL,
                 ops_per_summary: Optional[int] = None,
                 segs_per_chunk: int = snapcols.SEGS_PER_CHUNK,
                 text_split: int = snapcols.TEXT_SPLIT_CHARS):
        self.server = server
        self.applier = applier
        self.ds_id = ds_id
        self.channel_id = channel_id
        self.ops_per_summary = ops_per_summary
        self.segs_per_chunk = segs_per_chunk
        self.text_split = text_split
        self.summaries_written = 0
        self.refusals: list[tuple[str, str, str]] = []
        self.counters = tier_counters("service")
        # (tenant, doc) → chunk-hash set of the last written generation
        # (seeded from the prior acked snapcols version on first touch,
        # so dedupe survives summarizer restarts)
        self._last_chunks: dict = {}
        # (tenant, doc) → stream seq at the last summary attempt — the
        # threshold loop's trigger state
        self._last_attempt_seq: dict = {}

    def summarize_doc(self, tenant_id: str, document_id: str) -> str:
        """Decode the doc from the device, compose a bootable container
        summary with scribe's protocol replica, upload, and ack it
        (scribe itself is the validator — a service summary commits
        directly, the writeServiceSummary contract)."""
        orderer = self.server._get_orderer(tenant_id, document_id)
        scribe = orderer.scribe
        pkg = self._check_summarizable(tenant_id, document_id, orderer)
        replica = self.applier.get_tree(tenant_id, document_id)
        storage = self.server.storage(tenant_id, document_id)
        snap = replica.snapshot()
        chunks = snapcols.encode_snapshot_chunks(
            snap, self.segs_per_chunk, self.text_split)
        prior = self._prior_chunks(tenant_id, document_id, storage)
        chunk_ids = []
        for chunk in chunks:
            chunk_id = hashlib.sha256(chunk).hexdigest()
            if chunk_id in prior:
                # content-addressed dedupe across generations: the blob
                # is already durable, only the root record names it again
                self.counters.inc("storage.snapshot.chunks_reused")
            else:
                chunk_id = storage.write_blob(chunk)
                self.counters.inc("storage.snapshot.chunks_written")
            chunk_ids.append(chunk_id)
        summary = snapcols_root(
            snap, chunk_ids, scribe.protocol.snapshot(),
            scribe.protocol.sequence_number, pkg, self.ds_id,
            self.channel_id)
        version_id = storage.upload_summary(
            summary, parent=scribe.last_summary_head)
        plane = self.fault_plane
        if plane is not None:
            # crash window: chunks + version record uploaded, commit not
            # yet run — the version must stay invisible to boots
            plane("snapshot.upload", tenant=tenant_id, doc=document_id)
        # the service is its own validator, but must still commit through
        # the scribe's ref-update path so the version reaches the durable
        # versions topic (survives process death) and retention advances
        scribe.commit_version(version_id, scribe.protocol.sequence_number)
        # history plane hook: the committed generation becomes a commit
        # node in the doc's ref graph (refs/main advances; forks and
        # time-travel resolve against these)
        history = getattr(self.server, "history", None)
        if history is not None:
            history.record_commit(
                tenant_id, document_id, version_id,
                scribe.protocol.sequence_number, chunk_ids)
        # the gate pass proved full coverage — anchor the slot so the doc
        # stays summarizable after this commit's own retention truncation
        self.applier.mark_anchored(tenant_id, document_id)
        self.summaries_written += 1
        self._last_chunks[(tenant_id, document_id)] = set(chunk_ids)
        self._last_attempt_seq[(tenant_id, document_id)] = \
            scribe.protocol.sequence_number
        return version_id

    def _prior_chunks(self, tenant_id: str, document_id: str,
                      storage) -> set:
        """Chunk hashes of the previous summary generation (for dedupe):
        the in-memory set, or — first touch after a restart — the latest
        acked snapcols version's chunk list."""
        key = (tenant_id, document_id)
        cached = self._last_chunks.get(key)
        if cached is not None:
            return cached
        prior: set = set()
        try:
            import json

            versions = storage.get_versions(1)
            if versions:
                root = json.loads(
                    storage.read_blob(versions[0]["tree_id"]).decode())
                if root.get("t") == SNAPCOLS_KIND:
                    prior = set(root.get("chunks", ()))
        except (KeyError, ValueError):
            prior = set()
        self._last_chunks[key] = prior
        return prior

    # ------------------------------------------------ threshold loop

    def maybe_summarize(self, tenant_id: str,
                        document_id: str) -> Optional[str]:
        """Summarize iff the stream advanced ≥ ops_per_summary since the
        last attempt. Refusals also re-arm the threshold (retrying a
        permanent refusal every op would re-scan the log each time)."""
        if self.ops_per_summary is None:
            return None
        orderer = self.server._get_orderer(tenant_id, document_id)
        seq = orderer.deli.sequence_number
        key = (tenant_id, document_id)
        if seq - self._last_attempt_seq.get(key, 0) < self.ops_per_summary:
            return None
        try:
            return self.summarize_doc(tenant_id, document_id)
        except RuntimeError as e:
            self.refusals.append((tenant_id, document_id, str(e)))
            self._last_attempt_seq[key] = seq
            return None

    def run_pass(self, tenant_id: str, documents: list[str]) -> int:
        """One threshold-loop tick over the given docs (the service
        host calls this periodically): a single device fence, then a
        maybe_summarize per doc over threshold."""
        self.applier.finalize()
        n = 0
        for doc in documents:
            if self.maybe_summarize(tenant_id, doc) is not None:
                n += 1
        return n

    def _check_summarizable(self, tenant_id: str, document_id: str,
                            orderer) -> str:
        """The refusal gate (module docstring contract). Committing a
        service summary advances retention past scribe's seq, so anything
        the summary does not contain must provably not exist:

        - the applier must not LAG the stream (its state is the content);
        - the doc must hold ONLY the device-modeled data store/channel —
          foreign chanops truncated from the log while absent from the
          summary would be lost permanently;
        - the applier's coverage must be PROVEN complete: either anchored
          (checkpoint restore / authoritative replay / an earlier gate
          pass) or, with the log untruncated, ingested from the doc's
          first channel op. A max-seq check alone would admit an applier
          fed only the post-truncation tail and drop the prefix.
        - when retention already truncated a prefix, the PRIOR acked
          summary must not carry foreign content the stream no longer
          shows.

        Returns the data store's pkg (from its attach op, or the prior
        summary) so the new summary boots the same code."""
        from ..protocol.messages import MessageType

        base = orderer.scriptorium.retained_base(tenant_id, document_id)
        applied = self.applier.applied_seq(tenant_id, document_id)
        anchored = self.applier.is_anchored(tenant_id, document_id)
        if base > 0 and not anchored:
            raise RuntimeError(
                f"applier coverage for {tenant_id}/{document_id} is not "
                f"anchored and the log is truncated below seq {base}: "
                "the prefix is not provably in the device state")
        pkg = "default"
        first_channel_seq = 0
        last_channel_seq = 0
        # restart-window check: a checkpoint-restored anchor is only valid
        # if NO channel op was sequenced between the checkpoint and the
        # point the feed resumed — such ops are in the log but not in the
        # restored device state
        gap = self.applier.restore_gap(tenant_id, document_id)
        gap_lo, gap_hi = (gap if gap is not None else (None, None))
        if gap_lo is not None and base > gap_lo:
            # the log was truncated beyond the checkpoint point (a client
            # summary committed during/after the downtime): the restart
            # window is no longer inspectable, so coverage is unprovable
            raise RuntimeError(
                f"doc {tenant_id}/{document_id}: retention base {base} "
                f"passed the applier's checkpoint seq {gap_lo} while its "
                "restart window is unverified — keep client summaries")
        for m in orderer.scriptorium.get_deltas(
                tenant_id, document_id, base, 10**9):
            if m.type != MessageType.OPERATION:
                continue
            env = m.contents
            if not isinstance(env, dict):
                continue
            kind = env.get("kind")
            if kind == "attach":
                if env.get("id") != self.ds_id:
                    raise RuntimeError(
                        f"doc {tenant_id}/{document_id} has a data store "
                        f"{env.get('id')!r} the device does not model — "
                        "keep client summaries for this doc")
                pkg = env.get("pkg", pkg)
                foreign = set((env.get("snapshot") or {})
                              .get("channels") or {}) - {self.channel_id}
                if foreign:
                    raise RuntimeError(
                        f"doc {tenant_id}/{document_id} attached with "
                        f"non-modeled channels {sorted(foreign)}")
            elif kind == "chanop":
                inner = env.get("contents") or {}
                if env.get("address") != self.ds_id or \
                        inner.get("address") != self.channel_id:
                    raise RuntimeError(
                        f"doc {tenant_id}/{document_id} has ops for "
                        f"{env.get('address')}/{inner.get('address')} the "
                        "device does not model — keep client summaries")
                if "attach" not in inner:
                    last_channel_seq = m.sequence_number
                    if not first_channel_seq:
                        first_channel_seq = m.sequence_number
                    if gap_lo is not None and m.sequence_number > gap_lo \
                            and (gap_hi is None
                                 or m.sequence_number < gap_hi):
                        raise RuntimeError(
                            f"doc {tenant_id}/{document_id} has channel op "
                            f"seq {m.sequence_number} sequenced in the "
                            f"applier's restart window (checkpoint at "
                            f"{gap_lo}, feed resumed at {gap_hi}): the "
                            "restored state does not contain it")
        if applied < last_channel_seq:
            raise RuntimeError(
                f"applier lags the stream for {tenant_id}/{document_id}: "
                f"applied seq {applied} < last channel op "
                f"{last_channel_seq}; feed the applier before summarizing")
        if not anchored and first_channel_seq and \
                self.applier.first_seq(tenant_id, document_id) \
                > first_channel_seq:
            raise RuntimeError(
                f"applier for {tenant_id}/{document_id} started ingesting "
                f"at seq {self.applier.first_seq(tenant_id, document_id)} "
                f"but the doc's channel history starts at "
                f"{first_channel_seq}: coverage is incomplete")
        if base > 0:
            # content below the base is only reachable through the prior
            # acked summary — it must not hold anything we would drop
            prior = self.server.storage(tenant_id,
                                 document_id).get_snapshot_tree()
            stores = ((prior or {}).get("runtime") or {}) \
                .get("dataStores") or {}
            foreign_ds = set(stores) - {self.ds_id}
            ours = (stores.get(self.ds_id) or {})
            foreign_ch = set((ours.get("snapshot") or {})
                             .get("channels") or {}) - {self.channel_id}
            if foreign_ds or foreign_ch:
                raise RuntimeError(
                    f"prior summary of {tenant_id}/{document_id} holds "
                    f"non-modeled content (stores {sorted(foreign_ds)}, "
                    f"channels {sorted(foreign_ch)}) — keep client "
                    "summaries for this doc")
            pkg = ours.get("pkg", pkg)
        return pkg

    def summarize_all(self, tenant_id: str, documents: list[str],
                      min_seq: Optional[int] = None) -> int:
        """The batch pass (BASELINE config 5): one device fence, then a
        decode+upload per doc. Returns the number summarized; docs the
        refusal gate rejects are SKIPPED (recorded in ``self.refusals``),
        not allowed to abort the rest of the fleet — they simply keep
        client summaries."""
        self.applier.finalize()  # one fence for the whole batch
        self.refusals: list[tuple[str, str, str]] = []
        n = 0
        for doc in documents:
            orderer = self.server._get_orderer(tenant_id, doc)
            if min_seq is not None and \
                    orderer.deli.sequence_number < min_seq:
                continue
            try:
                self.summarize_doc(tenant_id, doc)
            except RuntimeError as e:
                self.refusals.append((tenant_id, doc, str(e)))
                continue
            n += 1
        return n
