"""The port's code loader (``loader/code_loader.py``) against
``tests/test_code_loader.py``.

Each test is the twin of the JAX test of the same name: its scenario runs
on each package's client stack (runtime classes derived from that
package's ``ContainerRuntime``) over that package's ``LocalServer``
(``torch_stack_fixtures.both``), with the JAX test's assertions. Between
the packages, the agreed code proposal, the booted runtime's code
version, the text, the refusal's text and everything the server stored
(``torch_stack_fixtures.stored``) are equal exactly. Tolerance: exact.
"""

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both, stored


def make_loader(s):
    base = s.mod("runtime.container_runtime").ContainerRuntime

    class RuntimeV1(base):
        code_version = "v1"

    class RuntimeV2(base):
        code_version = "v2"

    code = s.mod("loader.code_loader").CodeLoader()
    code.register("app/v1", RuntimeV1)
    code.register("app/v2", RuntimeV2)
    return s.st.Loader(s.st.LocalDocumentServiceFactory(s.server),
                       code_loader=code), RuntimeV2, base


def commit_proposals(s, container):
    noop = s.mod("protocol.messages").MessageType.NOOP
    container.delta_manager.submit(noop, None)
    container.delta_manager.submit(noop, None)


def _agreed_code(s):
    loader, runtime_v2, _ = make_loader(s)
    c1 = loader.resolve("t", "doc")
    c1.propose_code({"package": "app/v2", "config": {}})
    commit_proposals(s, c1)
    assert c1.quorum.get("code")["package"] == "app/v2"
    ds = c1.runtime.create_data_store("default")
    ds.create_channel("text", "shared-string").insert_text(0, "hi")
    s.st.SummaryManager(c1, max_ops=10**9).summarize_now()
    c2 = loader.resolve("t", "doc")
    assert type(c2.runtime) is runtime_v2
    text = c2.runtime.get_data_store("default").get_channel(
        "text").get_text()
    assert text == "hi"
    s.note([c1.quorum.get("code"), c2.runtime.code_version, text,
            stored(s.server)])


def test_agreed_code_selects_runtime_on_boot():
    both(_agreed_code)


def _unregistered(s):
    loader, _, _ = make_loader(s)
    c1 = loader.resolve("t", "doc")
    c1.propose_code({"package": "app/v3-not-installed"})
    commit_proposals(s, c1)
    c1.runtime.create_data_store("default")
    s.st.SummaryManager(c1, max_ops=10**9).summarize_now()
    with pytest.raises(KeyError, match="v3-not-installed") as err:
        loader.resolve("t", "doc")
    s.note([str(err.value), stored(s.server)])


def test_unregistered_package_fails_boot():
    both(_unregistered)


def _default_factory(s):
    loader, _, base = make_loader(s)
    c1 = loader.resolve("t", "doc")
    assert type(c1.runtime) is base
    s.note([type(c1.runtime).__name__, stored(s.server)])


def test_without_proposal_default_factory_boots():
    both(_default_factory)
