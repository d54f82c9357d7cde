"""Noisy-neighbor chaos scenario: one tenant floods, the other rides.

JAX counterpart: ``fluidframework_tpu/chaos/noisy.py``; the port's copy,
imports rebased to this package.

``python -m fluidframework_tpu_torch.chaos.noisy --seed N`` drives two
driver-stack tenants against one in-process NetworkFrontEnd with the
overload control loop armed:

- ``flood`` has a configured admission budget (token bucket) and
  submits ~10× it in a burst;
- ``steady`` has NO configured rate — structurally unsheddable — and
  trickles ops before, during, and after the flood.

The SLO engine runs WITHOUT its ticker thread: the scenario calls
``evaluate()`` itself on a hair-trigger spec (p99 budget 0 ms on the
``submit_to_admit`` leg, one burn tick), so the shed signal arms at a
deterministic point instead of racing a 500 ms ticker. The run fails
(exit 1, flight-recorder dump path attached) unless:

- every steady op AND every flood op eventually resolves (the driver's
  transparent shed-retry lane must drain the backlog through the
  server's resume watermark without gapping clientSeq at deli);
- ``net.admission.shed`` rose, and every label set it carries names the
  FLOOD tenant only — a single shed op attributed to the steady tenant
  is an isolation violation;
- the flood connection's driver counted ``driver.submit.shed_retries``
  while the steady connection counted none;
- ``obs.slo.state{slo=...}`` reached ``violated``,
  ``obs.slo.violations`` counted the transition, and the engine wrote
  its flight-recorder dump.

Same seed ⇒ same op contents and batch shapes. Green is required at
seeds 0, 7 and 42; ``--quick`` (CI) shrinks the flood.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

FLOOD_TENANT = "flood"
STEADY_TENANT = "steady"
DOC = "noisy"

#: flood tenant's admission budget (ops/s and burst)
CAP = 400.0

_TEXT_POOL = "abcdefgh" * 4


def wait_for(pred, timeout: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return bool(pred())


class _Tenant:
    """One tenant's driver connection + ack ledger (own factory so the
    driver counters — shed_retries above all — stay per-tenant)."""

    def __init__(self, host: str, port: int, tenant: str,
                 rng: random.Random):
        from ..driver.network import NetworkDocumentServiceFactory

        self.rng = rng
        self.factory = NetworkDocumentServiceFactory(host, port)
        self.conn = self.factory.create_document_service(
            tenant, DOC).connect_to_delta_stream()
        # every boxcar sampled: the hair-trigger SLO needs windowed
        # submit_to_admit observations from the very first submit
        self.conn.trace_sample_n = 1
        self.cseq = 0
        self.submitted = 0
        self.acked = 0
        #: hard refusals (anything that is NOT a transparent shed
        #: retry); a single one wedges the stream, so the scenario
        #: surfaces them by name instead of timing out blind
        self.hard_nacks: list[str] = []
        me = self.conn.client_id

        def on_op(m):
            if m.client_id == me:
                self.acked += 1

        def on_nack(m):
            self.hard_nacks.append(
                f"code={m.code} type={getattr(m.type, 'value', m.type)} "
                f"msg={m.message!r}")
        self.conn.on_op = on_op
        self.conn.on_nack = on_nack

    def submit_boxcar(self, n: int) -> None:
        from ..protocol.messages import DocumentMessage, MessageType

        ops = []
        for _ in range(n):
            self.cseq += 1
            off = self.rng.randrange(8)
            text = _TEXT_POOL[off:off + 1 + self.rng.randrange(6)]
            ops.append(DocumentMessage(
                client_sequence_number=self.cseq,
                reference_sequence_number=0,
                type=MessageType.OPERATION,
                contents={"kind": "chanop", "address": "default",
                          "contents": {"address": "text",
                                       "contents": {"type": 0, "pos": 0,
                                                    "text": text}}}))
        self.conn.submit(ops)
        self.submitted += n

    @property
    def settled(self) -> bool:
        return self.acked >= self.submitted

    def shed_retries(self) -> int:
        return self.factory.counters.snapshot().get(
            "driver.submit.shed_retries", 0)

    def close(self) -> None:
        self.conn.close()


def run_noisy(seed: int, quick: bool = False) -> dict:
    from ..obs import get_recorder, get_registry, parse_prometheus
    from ..obs.slo import STATE_VIOLATED, SloEngine, SloSpec
    from ..service.front_end import NetworkFrontEnd
    from ..service.local_server import LocalServer
    from ..service.tenants import TenantManager

    flood_ops = 800 if quick else 2000
    boxcar = 20

    tm = TenantManager()
    tm.set_rate(FLOOD_TENANT, CAP, burst=CAP)
    front = NetworkFrontEnd(LocalServer(tenants=tm)).start_background()
    engine = SloEngine([SloSpec(
        name="noisy_admit", pair="submit_to_admit", p99_budget_ms=0.0,
        window_s=10.0, burn_ticks=1, min_count=1)])
    front.attach_slo(engine, shedding=True)

    problems: list[str] = []
    try:
        steady = _Tenant("127.0.0.1", front.port, STEADY_TENANT,
                         random.Random(seed * 1000 + 1))
        flood = _Tenant("127.0.0.1", front.port, FLOOD_TENANT,
                        random.Random(seed * 1000 + 2))

        # prime: a few steady boxcars populate the windowed series, then
        # one manual tick trips the hair-trigger spec — the shed signal
        # is armed BEFORE the flood, deterministically
        for _ in range(3):
            steady.submit_boxcar(2)
        if not wait_for(lambda: steady.settled):
            problems.append("steady prime ops never resolved")
        engine.evaluate()
        if not engine.shed_signal:
            problems.append(
                f"hair-trigger SLO did not arm shedding: {engine.status()}")

        # flood ~10× the budget in one burst, steady trickling through
        # it; periodic manual ticks stand in for the disabled ticker
        sent = 0
        while sent < flood_ops:
            flood.submit_boxcar(boxcar)
            sent += boxcar
            if sent % (boxcar * 10) == 0:
                steady.submit_boxcar(2)
                engine.evaluate()
        engine.evaluate()
        if engine._state["noisy_admit"] != STATE_VIOLATED:
            problems.append(
                f"SLO never reached violated: {engine.status()}")

        # drain: the steady tenant must resolve promptly; the flood
        # backlog must drain through the shed-retry lane (bucket refill
        # + the full-bucket oversize admission, see admission.py)
        steady.submit_boxcar(2)
        if not wait_for(lambda: steady.settled, timeout=30.0):
            problems.append(
                f"steady ops unresolved: {steady.acked}/{steady.submitted}")
        if not wait_for(lambda: flood.settled, timeout=120.0):
            problems.append(
                f"flood ops unresolved: {flood.acked}/{flood.submitted}")
        for name, t in (("steady", steady), ("flood", flood)):
            if t.hard_nacks:
                problems.append(
                    f"{name} took {len(t.hard_nacks)} hard nack(s), "
                    f"first: {t.hard_nacks[0]}")

        series = parse_prometheus(get_registry().scrape())
        shed = series.get("fluid_net_admission_shed", {})
        shed_total = sum(shed.values())
        shed_tenants = sorted({dict(k).get("tenant") for k in shed})
        if shed_total <= 0:
            problems.append("flood never shed (net.admission.shed == 0)")
        if shed_tenants not in ([], [FLOOD_TENANT]):
            problems.append(
                f"shed series leaked beyond the flood tenant: "
                f"{shed_tenants}")
        if flood.shed_retries() <= 0:
            problems.append(
                "flood driver never exercised the shed-retry lane")
        if steady.shed_retries() != 0:
            problems.append(
                f"STEADY driver retried sheds "
                f"({steady.shed_retries()}) — isolation broken")
        violations = sum(
            series.get("fluid_obs_slo_violations", {}).values())
        if violations < 1:
            problems.append("obs.slo.violations never counted")
        dump = get_recorder().last_dump
        if not dump:
            problems.append("no flight-recorder dump on the violation")

        result = {
            "seed": seed,
            "flood": {"submitted": flood.submitted, "acked": flood.acked,
                      "shed_retries": flood.shed_retries()},
            "steady": {"submitted": steady.submitted,
                       "acked": steady.acked},
            "shed_ops": shed_total,
            "shed_tenants": shed_tenants,
            "slo": engine.status(),
            "flight_dump": dump,
        }
        steady.close()
        flood.close()
    finally:
        engine.stop()
        front.stop()
    if problems:
        raise AssertionError("; ".join(problems))
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="noisy-neighbor overload-control scenario")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true",
                        help="smaller flood (CI smoke)")
    args = parser.parse_args(argv)
    try:
        result = run_noisy(args.seed, quick=args.quick)
    except AssertionError as e:
        from ..obs import get_recorder

        dump = get_recorder().last_dump
        where = f"\n  flight recorder: {dump}" if dump else ""
        print(f"NOISY FAILED (seed {args.seed}): {e}{where}",
              file=sys.stderr)
        return 1
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
