"""Composable execution stages of the round engine.

The counterpart of :mod:`repro.exec.stages`, with the two communication
stages ported so far:

  ============ =========================================================
  stage        concern (and its slice of the engine's carried state)
  ============ =========================================================
  UplinkComm   the client->server message through a
               :mod:`repro_torch.comm` Transport (error-feedback residuals)
  DownlinkComm the server->client broadcast through a
               :class:`repro_torch.comm.DownlinkCompressor` (the
               client-visible shadow state)
  ============ =========================================================

:meth:`repro_torch.exec.EngineConfig.resolve` builds a :class:`StageStack`
from the config's stage fields.  The reference's Placement, Asynchrony and
Cohort stages are not ported yet: their config fields raise, naming the
slice that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class UplinkComm:
    """Client->server transport on the uplink message.

    ``transport=None`` resolves to the identity :class:`repro_torch.comm.Dense`
    (the stage still splits the round into its local/server halves, which
    the downlink stage builds on).
    """

    transport: Any = None
    name: str = "uplink"

    def resolve_transport(self):
        if self.transport is None:
            from repro_torch.comm import Dense

            return Dense()
        return self.transport


@dataclass(frozen=True)
class DownlinkComm:
    """Server->client broadcast compression (shadow-state error feedback)."""

    compressor: Any
    name: str = "downlink"

    @classmethod
    def coerce(cls, obj) -> "DownlinkComm":
        """Accept a DownlinkCompressor or a plain Transport (wrapped)."""
        if isinstance(obj, DownlinkComm):
            return obj
        if not hasattr(obj, "broadcast"):  # plain Transport
            from repro_torch.comm import DownlinkCompressor

            obj = DownlinkCompressor(obj)
        return cls(obj)


@dataclass(frozen=True)
class StageStack:
    """The resolved, validated stage combination one engine runs."""

    uplink: Optional[UplinkComm] = None
    downlink: Optional[DownlinkComm] = None

    @property
    def split(self) -> bool:
        """Whether the round runs as local/server halves joined by an
        explicit message exchange (any communication-shaped stage)."""
        return self.uplink is not None or self.downlink is not None

    def names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in (self.uplink, self.downlink)
                     if s is not None)
