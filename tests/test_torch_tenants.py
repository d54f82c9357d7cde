"""Tenancy twin: the port's ``service/tenants.py`` against the JAX
package's, on the CPU.

The in-process cases of ``tests/test_tenancy_config.py`` run through both
packages: token mint and validation, the refusal of every bad token, open
dev mode, and the server's connect check. A token minted by one package
validates in the other, and the two mint the same bytes for the same
claims. The wire cases run in process: a port front end on a background
thread with a tenant registry refuses a bad token at connect, at the
delta-storage door and at the storage door.
"""

import time

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu.service import tenants as jax_tenants
from fluidframework_tpu.service.local_server import LocalServer as JaxServer
from fluidframework_tpu_torch.service import tenants as port_tenants
from fluidframework_tpu_torch.service.local_server import LocalServer

PACKAGES = {"jax": (jax_tenants, JaxServer),
            "torch": (port_tenants, LocalServer)}


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both packages read ``time.time()`` for ``iat``/``exp``: one frozen
    instant makes their tokens comparable byte for byte."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_valid_token_accepted_and_claims_returned(pkg, frozen_clock):
    mod, _ = PACKAGES[pkg]
    tm = mod.TenantManager()
    tm.register("acme", "s3cret")
    token = mod.sign_token("acme", "doc1", "s3cret", user={"id": "u7"})
    claims = tm.validate(token, "acme", "doc1")
    assert claims["user"]["id"] == "u7"
    assert token == jax_tenants.sign_token("acme", "doc1", "s3cret",
                                           user={"id": "u7"})


def _bad_token(mod, case):
    return {
        "wrong_secret": lambda: mod.sign_token("acme", "doc1", "WRONG"),
        "wrong_tenant": lambda: mod.sign_token("evil", "doc1", "s3cret"),
        "wrong_doc": lambda: mod.sign_token("acme", "other", "s3cret"),
        "expired": lambda: mod.sign_token("acme", "doc1", "s3cret",
                                          lifetime_s=-10),
        "missing": lambda: None,
        "malformed": lambda: "not.a.token",
        "scope": lambda: mod.sign_token("acme", "doc1", "s3cret",
                                        scopes=(mod.SCOPE_READ,)),
        "unknown_tenant": lambda: mod.sign_token("nobody", "doc1", "x"),
    }[case]()


@pytest.mark.parametrize("case", [
    "wrong_secret", "wrong_tenant", "wrong_doc", "expired", "missing",
    "malformed", "scope", "unknown_tenant",
])
def test_invalid_tokens_rejected(case, frozen_clock):
    """Each bad token is refused by both packages with the same message,
    whichever package minted it."""
    tenant = "nobody" if case == "unknown_tenant" else "acme"
    messages = {}
    for minter in (jax_tenants, port_tenants):
        token = _bad_token(minter, case)
        for pkg, (mod, _) in PACKAGES.items():
            tm = mod.TenantManager()
            tm.register("acme", "s3cret")
            with pytest.raises(mod.AuthError) as err:
                tm.validate(token, tenant, "doc1")
            messages[(minter.__name__, pkg)] = str(err.value)
    assert len(set(messages.values())) == 1, messages


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_empty_registry_is_open_dev_mode(pkg):
    mod, _ = PACKAGES[pkg]
    tm = mod.TenantManager()
    assert tm.validate(None, "any", "doc") == \
        jax_tenants.TenantManager().validate(None, "any", "doc")
    assert tm.validate(None, "any", "doc")["scopes"]
    assert not tm.enforcing


@pytest.mark.parametrize("minter", ["jax", "torch"])
def test_server_connect_enforces_tokens(minter):
    """A port server with a registry refuses a tokenless connect and
    admits a token minted by either package; a read-scope token gets a
    read connection whose submit is nacked, as in the JAX server."""
    mint = PACKAGES[minter][0].sign_token
    modes = {}
    for pkg, (mod, server_cls) in PACKAGES.items():
        tm = mod.TenantManager()
        tm.register("acme", "s3cret")
        server = server_cls(tenants=tm)
        with pytest.raises(mod.AuthError):
            server.connect("acme", "doc")
        conn = server.connect("acme", "doc",
                              token=mint("acme", "doc", "s3cret"))
        assert conn.client_id
        reader = server.connect("acme", "doc", token=mint(
            "acme", "doc", "s3cret", scopes=(mod.SCOPE_READ,)))
        nacks = []
        reader.on_nack = nacks.append
        reader.submit([])
        modes[pkg] = (conn.mode, reader.mode,
                      [(n.code, n.message) for n in nacks])
    assert modes["torch"] == modes["jax"]
    assert modes["torch"][:2] == ("write", "read")


def test_token_checks_over_the_wire():
    """A port front end with a tenant registry (in process) refuses a bad
    token at connect, at the delta-storage door and at the storage door,
    and admits tokens minted by the JAX package."""
    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
    )
    from fluidframework_tpu_torch.service.front_end import NetworkFrontEnd

    tm = port_tenants.TenantManager()
    tm.register("acme", "s3cret")
    front = NetworkFrontEnd(LocalServer(tenants=tm)).start_background()
    try:
        bare = NetworkDocumentServiceFactory("127.0.0.1", front.port) \
            .create_document_service("acme", "doc")
        with pytest.raises(RuntimeError, match="token"):
            bare.connect_to_delta_stream()
        with pytest.raises(RuntimeError, match="token"):
            bare.connect_to_delta_storage().get_deltas(0, 100)
        with pytest.raises(RuntimeError, match="token"):
            bare.connect_to_storage().write_blob(b"sneak")

        read_only = NetworkDocumentServiceFactory(
            "127.0.0.1", front.port,
            token_provider=lambda t, d: jax_tenants.sign_token(
                t, d, "s3cret", scopes=(jax_tenants.SCOPE_READ,))) \
            .create_document_service("acme", "doc")
        assert read_only.connect_to_delta_storage().get_deltas(0, 10) == []
        with pytest.raises(RuntimeError, match="scope"):
            read_only.connect_to_storage().write_blob(b"nope")

        full = NetworkDocumentServiceFactory(
            "127.0.0.1", front.port,
            token_provider=lambda t, d: jax_tenants.sign_token(
                t, d, "s3cret")).create_document_service("acme", "doc")
        conn = full.connect_to_delta_stream()
        assert conn.client_id
        conn.close()
        blob_id = full.connect_to_storage().write_blob(b"legit")
        assert full.connect_to_storage().read_blob(blob_id) == b"legit"
    finally:
        front.stop()


def test_admin_tenant_registry_door():
    """``admin_tenant_add``/``remove``/``list`` over the admin RPC of a
    port front end: the registry appears on first add and enforces."""
    from fluidframework_tpu_torch.service.front_end import NetworkFrontEnd
    from fluidframework_tpu_torch.service.placement_plane import admin_rpc

    front = NetworkFrontEnd(LocalServer(),
                            admin_secret="adm").start_background()
    try:
        def rpc(**frame):
            return admin_rpc("127.0.0.1", front.port,
                             dict(frame, secret="adm"))

        assert front.server.tenants is None
        assert rpc(t="admin_tenant_add", id="acme",
                   tenant_secret="s3cret")["ok"]
        assert front.server.tenants.enforcing
        with pytest.raises(port_tenants.AuthError):
            front.server.connect("acme", "doc")
        assert rpc(t="admin_tenants")["tenants"] == ["acme"]
        assert rpc(t="admin_tenant_remove", id="acme")["ok"]
        assert not rpc(t="admin_tenant_remove", id="acme")["ok"]
    finally:
        front.stop()
