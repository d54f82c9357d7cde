"""AgentScheduler: distributed exclusive task ownership.

JAX counterpart: ``fluidframework_tpu/runtime/agent_scheduler.py``; the port's copy,
imports rebased to this package.

Ref: packages/runtime/agent-scheduler (scheduler.ts:34 pick/release,
TaskManager :366) — tasks like "summarizer"/"intel" must run on exactly
one client; ownership is decided through a ConsensusRegisterCollection
(volunteers write their clientId; the register's atomic read — earliest
surviving version — is the winner), and reassignment on owner departure
rides the sequenced CLIENT_LEAVE every replica sees at the same point in
the total order.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..protocol.messages import MessageType, SequencedDocumentMessage

SCHEDULER_CHANNEL = "agent-scheduler"


class AgentScheduler:
    """Attach one per container; ``pick(task, cb)`` volunteers this
    client. ``cb(owned: bool)`` fires on ownership changes."""

    def __init__(self, container, ds_id: str = "default"):
        self.container = container
        ds = container.runtime.get_data_store(ds_id)
        if SCHEDULER_CHANNEL in ds.channels:
            self.registers = ds.get_channel(SCHEDULER_CHANNEL)
        else:
            self.registers = ds.create_channel(
                SCHEDULER_CHANNEL, "consensus-register-collection")
        self._wanted: dict[str, Callable[[bool], None]] = {}
        self._owned: set[str] = set()
        # bids written but not yet resolved — guards against re-bidding
        # on every observed message while our own write is in flight
        self._bid_pending: set[str] = set()
        container.add_message_observer(self._observe)

    # ---------------------------------------------------------------- api

    def pick(self, task: str, cb: Optional[Callable[[bool], None]] = None
             ) -> None:
        """Volunteer for a task (ref: scheduler.ts pick). Ownership is
        decided by the register consensus; losers stay volunteers and
        take over if the owner leaves."""
        self._wanted[task] = cb or (lambda owned: None)
        self._maybe_bid(task)
        self._refresh()

    def release(self, task: str) -> None:
        """Stop volunteering; an owned task is handed off by writing a
        vacancy every volunteer observes (ref: scheduler.ts release)."""
        self._wanted.pop(task, None)
        if task in self._owned:
            self.registers.write(task, None)
        self._refresh()

    def owner(self, task: str) -> Optional[str]:
        """The LIVE owner: the register winner if still in the quorum."""
        winner = self.registers.read(task, policy="atomic")
        members = self.container.quorum.members
        if winner is not None and winner in members:
            return winner
        return None

    def owns(self, task: str) -> bool:
        return self.owner(task) == self.container.client_id \
            and self.container.client_id is not None

    @property
    def tasks(self) -> list[str]:
        return self.registers.keys()

    # ------------------------------------------------------------ internal

    def _maybe_bid(self, task: str) -> None:
        if self.owner(task) is None and task not in self._bid_pending:
            self._bid_pending.add(task)
            self.registers.write(task, self.container.client_id)

    def _observe(self, msg: SequencedDocumentMessage) -> None:
        # vacancies appear on owner CLIENT_LEAVE or an explicit release
        # write; every volunteer re-bids at the same total-order point
        # and the register consensus picks one winner
        for task in list(self._wanted):
            if self.owner(task) is not None:
                self._bid_pending.discard(task)  # race resolved
            else:
                self._maybe_bid(task)
        self._refresh()

    def _refresh(self) -> None:
        # snapshot: callbacks may pick()/release() (one-shot tasks)
        for task, cb in list(self._wanted.items()):
            owned_now = self.owns(task)
            was = task in self._owned
            if owned_now and not was:
                self._owned.add(task)
                cb(True)
            elif not owned_now and was:
                self._owned.discard(task)
                cb(False)
