"""Context — the flattened runtime parameter set every spec function takes.

Reference parity: ethereum-consensus/src/state_transition/context.rs:20-485:
~110 fields merging all fork presets with the network Config, constructors
for the built-in networks + custom YAML (try_from_file:154), the fork
schedule (fork_for:426) and the mock execution-engine toggle. The lazy KZG
settings and the slot clock come with the modules that provide them.
"""

from __future__ import annotations

from dataclasses import fields as dataclass_fields

from ..fork import Fork
from ..primitives import FAR_FUTURE_EPOCH
from .config import (
    Config,
    goerli_config,
    holesky_config,
    mainnet_config,
    minimal_config,
    sepolia_config,
)
from .presets import MAINNET, MINIMAL, PRESETS, Preset

__all__ = ["Context"]


class Context:
    """Flat attribute bag: every preset constant (UPPERCASE) + every config
    field (lowercase), plus orchestration state."""

    def __init__(self, preset: Preset, config: Config):
        self.preset = preset
        self.config = config
        # flatten presets: UPPERCASE names
        for sub in (preset.phase0, preset.altair, preset.bellatrix,
                    preset.capella, preset.deneb, preset.electra):
            for f in dataclass_fields(sub):
                setattr(self, f.name, getattr(sub, f.name))
        # flatten config: lowercase names
        for f in dataclass_fields(config):
            setattr(self, f.name, getattr(config, f.name))

        # the ExecutionEngine mock (execution_engine.rs: `impl ExecutionEngine
        # for bool`): True accepts every payload, False rejects.
        self.execution_engine: bool = True

    def scoped_execution_engine(self, engine):
        """Context manager that swaps ``execution_engine`` for the scope
        and restores it on exit — the explicit, leak-proof equivalent of
        the reference's feature-gated field access (context.rs:143-147),
        used by the conformance harness to inject expected payload
        validity per test case."""
        from contextlib import contextmanager

        @contextmanager
        def _scope():
            saved = self.execution_engine
            self.execution_engine = engine
            try:
                yield self
            finally:
                self.execution_engine = saved

        return _scope()

    # -- constructors (context.rs:152-424) ----------------------------------
    @classmethod
    def for_mainnet(cls) -> "Context":
        return cls(MAINNET, mainnet_config())

    @classmethod
    def for_minimal(cls) -> "Context":
        return cls(MINIMAL, minimal_config())

    @classmethod
    def for_goerli(cls) -> "Context":
        return cls(MAINNET, goerli_config())

    @classmethod
    def for_sepolia(cls) -> "Context":
        return cls(MAINNET, sepolia_config())

    @classmethod
    def for_holesky(cls) -> "Context":
        return cls(MAINNET, holesky_config())

    @classmethod
    def try_from_file(cls, path: str) -> "Context":
        config = Config.from_file(path)
        preset = PRESETS.get(config.preset_base)
        if preset is None:
            raise ValueError(f"unknown preset base {config.preset_base!r}")
        return cls(preset, config)

    # -- fork schedule (context.rs:426-441) ----------------------------------
    def fork_schedule(self) -> list[tuple[Fork, int]]:
        return [
            (Fork.PHASE0, 0),
            (Fork.ALTAIR, self.altair_fork_epoch),
            (Fork.BELLATRIX, self.bellatrix_fork_epoch),
            (Fork.CAPELLA, self.capella_fork_epoch),
            (Fork.DENEB, self.deneb_fork_epoch),
            (Fork.ELECTRA, self.electra_fork_epoch),
        ]

    def fork_for(self, slot: int) -> Fork:
        epoch = slot // self.SLOTS_PER_EPOCH
        return self.fork_at_epoch(epoch)

    def fork_at_epoch(self, epoch: int) -> Fork:
        current = Fork.PHASE0
        for fork, activation in self.fork_schedule():
            if activation == FAR_FUTURE_EPOCH:
                continue
            if epoch >= activation:
                current = fork
        return current

    def fork_version_for(self, fork: Fork) -> bytes:
        return {
            Fork.PHASE0: self.genesis_fork_version,
            Fork.ALTAIR: self.altair_fork_version,
            Fork.BELLATRIX: self.bellatrix_fork_version,
            Fork.CAPELLA: self.capella_fork_version,
            Fork.DENEB: self.deneb_fork_version,
            Fork.ELECTRA: self.electra_fork_version,
        }[fork]

    def fork_activation_epoch(self, fork: Fork) -> int:
        return {
            Fork.PHASE0: 0,
            Fork.ALTAIR: self.altair_fork_epoch,
            Fork.BELLATRIX: self.bellatrix_fork_epoch,
            Fork.CAPELLA: self.capella_fork_epoch,
            Fork.DENEB: self.deneb_fork_epoch,
            Fork.ELECTRA: self.electra_fork_epoch,
        }[fork]

    def __repr__(self) -> str:
        return f"Context(preset={self.preset.name!r}, config={self.config.name!r})"
