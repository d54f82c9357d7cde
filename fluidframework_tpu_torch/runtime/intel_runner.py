"""Intelligence runner: the canonical attached agent.

JAX counterpart: ``fluidframework_tpu/runtime/intel_runner.py``; the port's copy,
imports rebased to this package.

Ref: packages/agents/intelligence-runner-agent (+ the clicker/shared-text
intel agents, server/headless-agent) — an agent attaches to a document,
wins the "intel" task through the agent scheduler, and continuously
publishes derived analytics (text statistics, translations, …) back INTO
the document as shared state, so every client sees the analysis converge
through the same total order as the data.
"""

from __future__ import annotations

from .agent_scheduler import AgentScheduler

INTEL_TASK = "intel"
INTEL_CHANNEL = "intel-results"


class IntelRunner:
    """Maintains a shared-map of text statistics for one shared-string.

    Exactly one runner per document does the work (scheduler-elected);
    the rest stay hot standbys and take over on departure.
    """

    def __init__(self, container, ds_id: str = "default",
                 text_channel: str = "text"):
        self.container = container
        self._ds = container.runtime.get_data_store(ds_id)
        self._text = self._ds.get_channel(text_channel)
        if INTEL_CHANNEL in self._ds.channels:
            self.results = self._ds.get_channel(INTEL_CHANNEL)
        else:
            self.results = self._ds.create_channel(INTEL_CHANNEL,
                                                   "shared-map")
        self.scheduler = AgentScheduler(container, ds_id)
        self.runs = 0
        self.scheduler.pick(INTEL_TASK, self._on_ownership)
        self._text.on("sequenceDelta", self._on_delta)
        if self.scheduler.owns(INTEL_TASK):
            self._analyze()

    @property
    def is_running(self) -> bool:
        return self.scheduler.owns(INTEL_TASK)

    def _on_ownership(self, owned: bool) -> None:
        if owned:
            self._analyze()

    def _on_delta(self, *args) -> None:
        if self.is_running:
            self._analyze()

    def _analyze(self) -> None:
        text = self._text.get_text()
        words = [w for w in text.split() if w]
        self.results.set("chars", len(text))
        self.results.set("words", len(words))
        self.results.set("longest_word",
                         max(words, key=len) if words else "")
        self.results.set("analyzed_by", self.container.client_id)
        self.runs += 1
