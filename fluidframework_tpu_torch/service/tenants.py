"""Tenancy + token auth at the front door (the riddler role).

JAX counterpart: ``fluidframework_tpu/service/tenants.py``; the port's
copy of ``TenantManager`` (token mint and validate) and the scopes,
imports rebased to this package.

Ref: server/routerlicious/packages/routerlicious/src/riddler
(tenantManager.ts — tenant registry + per-tenant shared secret) and
protocol-definitions/src/tokens.ts (ITokenClaims: tenantId, documentId,
scopes, user, exp — a JWT signed with the tenant secret).

Tokens here are the same shape, HMAC-SHA256-signed compact JWS
(header.payload.signature, base64url) produced with the standard library
— no external JWT dependency. An empty registry means OPEN access (the
tinylicious/dev mode); registering any tenant turns enforcement on for
that tenant id.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Optional

SCOPE_READ = "doc:read"
SCOPE_WRITE = "doc:write"
DEFAULT_SCOPES = (SCOPE_READ, SCOPE_WRITE)


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class AuthError(Exception):
    """Token rejected: the front door refuses the connection."""


def sign_token(tenant_id: str, document_id: str, secret: str,
               user: Optional[dict] = None,
               scopes: tuple = DEFAULT_SCOPES,
               lifetime_s: float = 3600.0) -> str:
    """Client-side token mint (the reference's TokenProvider role)."""
    header = {"alg": "HS256", "typ": "JWT"}
    claims = {
        "tenantId": tenant_id,
        "documentId": document_id,
        "scopes": list(scopes),
        "user": user or {"id": "anonymous"},
        "iat": int(time.time()),
        "exp": int(time.time() + lifetime_s),
    }
    signing_input = (_b64(json.dumps(header, separators=(",", ":")).encode())
                     + "."
                     + _b64(json.dumps(claims, separators=(",", ":")).encode()))
    sig = hmac.new(secret.encode(), signing_input.encode(),
                   hashlib.sha256).digest()
    return f"{signing_input}.{_b64(sig)}"


class TenantManager:
    """Tenant registry + token validation (riddler's tenantManager)."""

    def __init__(self):
        self._secrets: dict[str, str] = {}
        # admission budgets, tenant -> (ops_per_s, burst). Deliberately
        # separate from _secrets: a rate cap must not flip `enforcing`
        # (auth) on, and the shard-host tenants.json sync persists
        # secrets only.
        self._rates: dict[str, tuple[float, float]] = {}

    def register(self, tenant_id: str, secret: str) -> None:
        self._secrets[tenant_id] = secret

    def set_rate(self, tenant_id: str, ops_per_s: float,
                 burst: Optional[float] = None) -> None:
        """Cap a tenant's admission rate; ``ops_per_s <= 0`` clears it.

        Tenants without a rate stay unlimited (the default), so
        configuring one noisy tenant never touches the rest."""
        if ops_per_s <= 0:
            self._rates.pop(tenant_id, None)
            return
        self._rates[tenant_id] = (
            float(ops_per_s),
            float(burst) if burst is not None else max(float(ops_per_s), 1.0))

    def rate_for(self, tenant_id: str) -> Optional[tuple[float, float]]:
        """(ops_per_s, burst) for the tenant, or None = unlimited."""
        return self._rates.get(tenant_id)

    def remove(self, tenant_id: str) -> bool:
        """Deregister a tenant; its tokens stop validating immediately."""
        return self._secrets.pop(tenant_id, None) is not None

    def list_tenants(self) -> list[str]:
        return sorted(self._secrets)

    def replace_all(self, secrets: dict) -> None:
        """Swap the whole registry in place (shared-registry reload:
        every server holding this instance sees the change at once)."""
        self._secrets.clear()
        self._secrets.update(secrets)

    @property
    def enforcing(self) -> bool:
        return bool(self._secrets)

    def validate(self, token: Optional[str], tenant_id: str,
                 document_id: str,
                 required_scope: str = SCOPE_WRITE) -> dict:
        """Return the verified claims, or raise AuthError.

        Unregistered tenants are refused outright once ANY tenant is
        registered (an open tenant next to secured ones would be a
        bypass); with an empty registry everything is open (dev mode).
        """
        if not self.enforcing:
            return {"tenantId": tenant_id, "documentId": document_id,
                    "scopes": list(DEFAULT_SCOPES)}
        secret = self._secrets.get(tenant_id)
        if secret is None:
            raise AuthError(f"unknown tenant {tenant_id!r}")
        if not token:
            raise AuthError("missing token")
        try:
            signing_input, _, sig_part = token.rpartition(".")
            want = hmac.new(secret.encode(), signing_input.encode(),
                            hashlib.sha256).digest()
            if not hmac.compare_digest(want, _unb64(sig_part)):
                raise AuthError("bad signature")
            claims = json.loads(_unb64(signing_input.split(".")[1]))
        except AuthError:
            raise
        except Exception as e:  # malformed structure/base64/json
            raise AuthError(f"malformed token: {e}") from None
        if claims.get("tenantId") != tenant_id:
            raise AuthError("token tenant mismatch")
        if claims.get("documentId") != document_id:
            raise AuthError("token document mismatch")
        if claims.get("exp", 0) < time.time():
            raise AuthError("token expired")
        if required_scope not in claims.get("scopes", []):
            raise AuthError(f"missing scope {required_scope!r}")
        return claims
