"""Checkpoint key census: strict state-dict consumption tracking.

The port's copy of ``moviigen_tpu/models/census.py``. The reference loads
checkpoints through ``load_state_dict`` (strict by default) or diffusers
``from_pretrained``, both of which error on missing or unexpected keys.
The converters here consume keys by name, which without tracking would
silently ignore renamed or extra keys in a real checkpoint.
``TrackedStateDict`` records every key read; a converter asserts
afterwards that nothing in the source dict went unconsumed, and a
missing key raises with the converter's context attached.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Set


class TrackedStateDict(Mapping):
    """Mapping wrapper recording which keys a converter consumed."""

    def __init__(self, sd: Mapping[str, Any], what: str = "checkpoint"):
        self._sd = sd
        self._what = what
        self.consumed: Set[str] = set()

    def __getitem__(self, key: str) -> Any:
        try:
            value = self._sd[key]
        except KeyError:
            raise KeyError(
                f"{self._what}: missing key '{key}' — the checkpoint "
                f"does not match the model config (renamed key, wrong "
                f"num_layers, or wrong variant)") from None
        self.consumed.add(key)
        return value

    def __contains__(self, key: object) -> bool:
        return key in self._sd

    def __iter__(self) -> Iterator[str]:
        return iter(self._sd)

    def __len__(self) -> int:
        return len(self._sd)

    def check_all_consumed(self) -> None:
        """Raise if any source key was never read by the converter — a
        silent ignore is a silently wrong model."""
        unused = sorted(set(self._sd) - self.consumed)
        if unused:
            preview = ", ".join(unused[:8])
            more = f" (+{len(unused) - 8} more)" if len(unused) > 8 else ""
            raise ValueError(
                f"{self._what}: {len(unused)} checkpoint key(s) not "
                f"consumed by the converter: {preview}{more} — refusing "
                f"to load a checkpoint the converter doesn't fully "
                f"understand (pass strict=False to override)")
