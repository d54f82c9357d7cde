"""Sequenced streams as the plain reference reads them, and the farm's
output as the comparison reads it."""

from __future__ import annotations

from ..reference.mergetree import rich_runs

OPERATION = "op"


def reference_ops(entries) -> list:
    """A doc's broadcast entries, in order, as the reference's op tuples
    ``(kind, a, b, text, props, seq, ref, client, msn)``. An entry is a
    ``SequencedArrayBatch`` or a list of sequenced messages; messages
    that are not text-channel merge-tree ops are skipped."""
    out = []
    for entry in entries:
        if type(entry) is list:
            for m in entry:
                if m.type != OPERATION:
                    continue
                env = m.contents
                if type(env) is not dict or env.get("kind") != "chanop":
                    continue
                op = env["contents"]["contents"]
                t = op["type"]
                a = op["pos"] if t == 0 else op["start"]
                out.append((t, a, op.get("end", 0), op.get("text", ""),
                            op.get("props"), m.sequence_number,
                            m.reference_sequence_number, m.client_id,
                            m.minimum_sequence_number))
            continue
        box = entry.boxcar
        kind = box.kind.tolist()
        a, b = box.a.tolist(), box.b.tolist()
        rseq = box.rseq.tolist()
        msns = entry.msns.tolist()
        off = box.text_off.tolist()
        text = box.text
        props = box.props
        for i in range(len(kind)):
            out.append((kind[i], a[i], b[i], text[off[i]:off[i + 1]],
                        props[i] if props else None, entry.base_seq + i,
                        rseq[i], box.client_id, msns[i]))
    return out


def entry_seqs(entry) -> tuple:
    """(first seq, last seq, op count) of a broadcast entry."""
    if type(entry) is list:
        seqs = [m.sequence_number for m in entry]
        ops = sum(1 for m in entry if m.type == OPERATION)
        return seqs[0], seqs[-1], ops
    return entry.base_seq, entry.base_seq + entry.n - 1, entry.n


def farm_rich_text(tree_client) -> list:
    """The rich text of a doc as the farm serves it: the visible
    segments of the replica its ``get_tree`` returns."""
    return rich_runs((seg.text, seg.props or {})
                     for seg in tree_client.tree.segments
                     if seg.rem_seq is None and seg.marker is None)


def first_difference(want: list, got: list) -> str:
    """Where two rich texts first differ, in a few words."""
    flat_w = "".join(t for t, _ in want)
    flat_g = "".join(t for t, _ in got)
    if flat_w != flat_g:
        i = next((i for i, (x, y) in enumerate(zip(flat_w, flat_g))
                  if x != y), min(len(flat_w), len(flat_g)))
        return (f"text differs at char {i} (reference {len(flat_w)} "
                f"chars, farm {len(flat_g)})")
    return "annotations differ"
