"""The client application layer as a whole, the port against the JAX
package: app documents whose body text the replica farm replicates.

Eight documents of BASELINE config 1's shape, as the smoke's ``apps``
phase makes 1,024 of them: each a ``DataObject`` from a
``DataObjectFactory`` with its root ``SharedDirectory``, a
``shared-cell`` title, a ``shared-string`` body and a ``shared-counter``,
two clients a document making the seeded edit script of
``fluidframework_tpu_torch/testing/apps.py``. Each package runs the
script on its own ``LocalServer`` (client ids under a fixed epoch, clock
at 0), and its replica farm ingests every document's ``("default",
"body")`` stream after each round: the JAX package's
``TpuDocumentApplier`` and the port's ``GpuDocumentApplier`` on the CPU.
Their state rows are equal, every farm text is both clients' body,
everything the two servers store is equal, both ``ServiceSummarizer``s
refuse an app document with the same message (it holds channels beside
the one the farm models), and a ``SummaryManager`` summary boots a third
container that reads the same channels in both packages. Exact: host
code and integer state, tolerance 0.
"""

import ast
import functools
from pathlib import Path

import numpy as np
from tests.torch_stack_fixtures import (
    containers_record,
    map_client_ids,
    module,
    stack,
    stored,
)

from fluidframework_tpu_torch.ops.doc_state import FIELDS
from fluidframework_tpu_torch.testing.apps import (
    app_factory,
    app_view,
    edit_app_docs,
    feed_bodies,
    open_app_docs,
)

ROOT = Path(__file__).resolve().parent.parent
DOCS = [f"doc{d}" for d in range(8)]
GEO = dict(max_docs=8, max_slots=256, ops_per_dispatch=32)
ROUNDS = 12
SEED = 12


@functools.cache
def _slice(pkg: str) -> dict:
    """The slice on one package (run once a package for this module)."""
    st = stack(pkg)
    server = st.server()
    loader = st.Loader(st.LocalDocumentServiceFactory(server))
    factory = app_factory(module(pkg, "framework"))
    apps = open_app_docs(loader, factory, "apps", DOCS)
    farm = st.applier(**GEO)
    farm.set_replay_source(lambda t, d: [])
    fed = []
    ops = edit_app_docs(
        server, apps, ROUNDS, SEED,
        after_round=lambda: fed.append(
            feed_bodies(server, farm, "apps", DOCS, st.channel_stream)))
    farm.finalize()
    out = {"ops": ops, "fed": fed, "escalations": farm.host_escalations}
    rows = np.array([farm.slot_of("apps", d) for d in DOCS])
    out["rows"] = {f: np.asarray(getattr(farm.state, f))[rows].tolist()
                   for f in FIELDS}
    out["farm_texts"] = [farm.get_text("apps", d) for d in DOCS]
    out["views"] = {d: [app_view(obj) for _, obj in cs]
                    for d, cs in apps.items()}

    svc = st.ServiceSummarizer(server, farm, channel_id="body")
    try:
        svc.summarize_doc("apps", DOCS[0])
    except RuntimeError as e:
        out["refusal"] = str(e)

    container, obj = apps[DOCS[1]][0]
    st.SummaryManager(container, max_ops=10**9).summarize_now()
    joiner = loader.resolve("apps", DOCS[1])
    out["boot_from_summary"] = joiner._base_snapshot is not None
    out["joiner"] = app_view(factory.create_or_load(joiner))
    out["record"] = map_client_ids(containers_record(
        [container, joiner]))
    out["stored"] = stored(server)
    return out


def test_app_docs_on_the_farm_equal_jax():
    want, got = _slice("jax"), _slice("torch")
    assert got["ops"] == want["ops"] == len(DOCS) * (2 * ROUNDS + 4)
    assert got["fed"] == want["fed"] and sum(got["fed"]) == \
        len(DOCS) * 2 * ROUNDS
    assert got["escalations"] == want["escalations"] == 0
    for f in FIELDS:
        assert got["rows"][f] == want["rows"][f], f
    assert got["farm_texts"] == want["farm_texts"]
    assert got["views"] == want["views"]
    for d, text in zip(DOCS, got["farm_texts"]):
        views = got["views"][d]
        assert [v["body"] for v in views] == [text, text]
        assert len({str(v) for v in views}) == 1
        assert views[0]["edits"] == 3 and views[0]["owner"] == "client 1"
    assert any(got["farm_texts"])
    assert got["stored"] == want["stored"]


#: the refusal of an app document (``chip_smoke.py``'s ``apps`` phase
#: expects it too): the farm models the body, and the first channel op
#: the gate meets is the root directory's attach
REFUSAL = ("doc apps/doc0 has ops for default/root the device does not "
           "model — keep client summaries")


def _smoke_refusal() -> str:
    """``chip_smoke.py``'s ``APPS_REFUSAL``, read without importing the
    smoke (its import sets process-wide environment)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                [t.id for t in node.targets] == ["APPS_REFUSAL"]:
            return ast.literal_eval(node.value)
    raise KeyError("APPS_REFUSAL")


def test_service_summarizer_refuses_app_docs_as_jax():
    want, got = _slice("jax"), _slice("torch")
    assert got["refusal"] == want["refusal"] == REFUSAL == _smoke_refusal()


def test_client_summary_boots_the_app_as_jax():
    want, got = _slice("jax"), _slice("torch")
    assert got["boot_from_summary"] and want["boot_from_summary"]
    assert got["joiner"] == want["joiner"] == got["views"][DOCS[1]][0]
    assert got["record"] == want["record"]
