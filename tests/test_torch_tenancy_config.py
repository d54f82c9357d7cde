"""The port's tenancy over a core process and its configuration registry,
twin of the cases of ``tests/test_tenancy_config.py`` that
``test_torch_tenants.py`` does not hold (it holds the token and registry
cases, and the wire checks against an in-process core).

The two wire cases run on one core process of the port started with
``--tenant acme:s3cret``, as the JAX tests start theirs, and assert the
JAX tests' properties (what a socket sees is not fixed by a seed). The
config cases run on each package with the JAX tests' assertions and
compare the resolved configs and limits between them exactly. The JAX
bool case reads ``FLUID_TPU_APPLIER_USE_PALLAS``, a switch of the TPU
kernel the port does not have; its twin parses the same spellings on the
port's boolean field, ``applier_overlap`` (``FLUID_TPU_APPLIER_OVERLAP``).
Tolerance: exact.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import module

from fluidframework_tpu_torch.config import Config
from fluidframework_tpu_torch.driver.network import (
    NetworkDocumentServiceFactory,
)
from fluidframework_tpu_torch.service.tenants import SCOPE_READ, sign_token

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("jax", "torch")


@pytest.fixture(scope="module")
def secured_core():
    """One core process of the port with a tenant registry: its port."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0", "--tenant", "acme:s3cret"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(ROOT))
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING"), line
        yield int(line.rsplit(":", 1)[1])
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_invalid_token_rejected_over_the_wire(secured_core):
    no_token = NetworkDocumentServiceFactory("127.0.0.1", secured_core)
    svc = no_token.create_document_service("acme", "doc")
    with pytest.raises(RuntimeError, match="token"):
        svc.connect_to_delta_stream()
    good = NetworkDocumentServiceFactory(
        "127.0.0.1", secured_core,
        token_provider=lambda t, d: sign_token(t, d, "s3cret"))
    conn = good.create_document_service(
        "acme", "doc").connect_to_delta_stream()
    assert conn.client_id
    conn.close()


def test_storage_and_backfill_rpcs_require_tokens_too(secured_core):
    bare = NetworkDocumentServiceFactory("127.0.0.1", secured_core) \
        .create_document_service("acme", "doc2")
    with pytest.raises(RuntimeError, match="token"):
        bare.connect_to_delta_storage().get_deltas(0, 100)
    with pytest.raises(RuntimeError, match="token"):
        bare.connect_to_storage().write_blob(b"sneak")
    read_only = NetworkDocumentServiceFactory(
        "127.0.0.1", secured_core,
        token_provider=lambda t, d: sign_token(
            t, d, "s3cret", scopes=(SCOPE_READ,))) \
        .create_document_service("acme", "doc2")
    assert read_only.connect_to_delta_storage().get_deltas(0, 10) == []
    with pytest.raises(RuntimeError, match="scope"):
        read_only.connect_to_storage().write_blob(b"nope")
    full = NetworkDocumentServiceFactory(
        "127.0.0.1", secured_core,
        token_provider=lambda t, d: sign_token(t, d, "s3cret")) \
        .create_document_service("acme", "doc2")
    blob_id = full.connect_to_storage().write_blob(b"legit")
    assert full.connect_to_storage().read_blob(blob_id) == b"legit"


def _config(pkg):
    return module(pkg, "config").Config


def _fields(cfg, names):
    return {n: getattr(cfg, n) for n in names}


SHARED = [f.name for f in dataclasses.fields(Config)]


def test_config_layering_defaults_overrides_env(monkeypatch):
    shown = {}
    for pkg in PKGS:
        config = _config(pkg)
        base = config()
        assert base.max_message_size == 16 * 1024
        c = base.with_overrides(max_message_size=1024)
        assert c.max_message_size == 1024
        assert base.max_message_size == 16 * 1024
        monkeypatch.setenv("FLUID_TPU_CLIENT_TIMEOUT_S", "42.5")
        env = config.from_env(c)
        monkeypatch.delenv("FLUID_TPU_CLIENT_TIMEOUT_S")
        assert env.client_timeout_s == 42.5
        assert env.max_message_size == 1024
        with pytest.raises(KeyError):
            base.with_overrides(nonsense=1)
        shown[pkg] = [_fields(cfg, SHARED) for cfg in (base, c, env)]
    assert shown["torch"] == shown["jax"]


def test_config_threads_into_service_limits():
    shown = {}
    for pkg in PKGS:
        cfg = _config(pkg)().with_overrides(client_timeout_s=7.0)
        now = [0.0]
        server = module(pkg, "service").LocalServer(
            clock=lambda: now[0], config=cfg)
        conn = server.connect("t", "doc")
        orderer = server._get_orderer("t", "doc")
        assert orderer.deli._client_timeout == 7.0
        now[0] = 8.0
        server.expire_idle_clients()
        assert conn.client_id not in orderer.deli.clients
        shown[pkg] = [orderer.deli._client_timeout,
                      sorted(orderer.deli.clients)]
    assert shown["torch"] == shown["jax"]


def test_config_sets_front_end_message_cap():
    caps = {}
    for pkg in PKGS:
        cfg = _config(pkg)().with_overrides(max_message_size=2048)
        fe = module(pkg, "service.front_end").NetworkFrontEnd(
            server=module(pkg, "service").LocalServer(config=cfg))
        assert fe.max_message_size == 2048
        caps[pkg] = fe.max_message_size
    assert caps["torch"] == caps["jax"]


def test_config_bool_env_parses_spellings(monkeypatch):
    for raw, want in [("0", False), ("false", False), ("no", False),
                      ("off", False), ("1", True), ("true", True),
                      ("YES", True), ("On", True)]:
        monkeypatch.setenv("FLUID_TPU_APPLIER_OVERLAP", raw)
        assert Config.from_env().applier_overlap is want, raw
    monkeypatch.setenv("FLUID_TPU_APPLIER_OVERLAP", "maybe")
    with pytest.raises(ValueError):
        Config.from_env()


def test_config_empty_env_value_keeps_default(monkeypatch):
    monkeypatch.setenv("FLUID_TPU_APPLIER_OVERLAP", "")
    assert Config.from_env().applier_overlap is Config().applier_overlap
    for pkg in PKGS:
        config = _config(pkg)
        monkeypatch.setenv("FLUID_TPU_CLIENT_TIMEOUT_S", "")
        assert config.from_env().client_timeout_s == \
            config().client_timeout_s
