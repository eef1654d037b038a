"""Lightweight YAML config system: nested YAML files with

* ``defaults``: a mapping of section -> group file, composed from
  ``<config_dir>/<section>/<name>.yaml`` (config groups);
* dotlist overrides (``trainer.max_epochs=10`` / ``model=small`` to swap a
  whole group);
* ``${section.key}`` interpolation resolved after composition.

Configs resolve to nested :class:`Config` namespaces with attribute access.
It reads the repository's ``configs/*.yaml`` as they are.
"""
from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Optional

import yaml


class Config(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_dict(self):
        def unwrap(v):
            if isinstance(v, Config):
                return v.to_dict()
            if isinstance(v, list):
                # wrap() converts dicts INSIDE lists to Config too; without
                # unwrapping them here yaml.safe_dump(cfg.to_dict()) raises
                # RepresenterError for any list-of-mappings value
                return [unwrap(x) for x in v]
            return v

        return {k: unwrap(v) for k, v in self.items()}


def _deep_merge(base: dict, extra: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_SCI_FLOAT = re.compile(r"^[+-]?\d+(\.\d*)?[eE][+-]?\d+$")


def _parse_value(s: str) -> Any:
    v = yaml.safe_load(s)
    if isinstance(v, str) and _SCI_FLOAT.match(v):
        # YAML 1.1 reads '3e-4' as a string (mantissa must be '3.0e-4');
        # accept exactly the scientific shorthand, like Hydra — a blanket
        # float() would also convert 'nan'/'infinity'/'1_000' strings
        return float(v)
    return v


_INTERP = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")


def _resolve_interpolations(node, root):
    if isinstance(node, dict):
        return {k: _resolve_interpolations(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_interpolations(v, root) for v in node]
    if isinstance(node, str):
        m = _INTERP.match(node)
        if m:
            cur = root
            for part in m.group(1).split("."):
                cur = cur[part]
            return cur
    return node


def _find_unresolved(node, path="") -> list[str]:
    """Leaf strings still matching the ``${...}`` interpolation syntax after
    the fixpoint loop converged (only a self/mutual reference can do that)."""
    out = []
    if isinstance(node, dict):
        for k, v in node.items():
            out += _find_unresolved(v, f"{path}.{k}" if path else str(k))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            out += _find_unresolved(v, f"{path}[{i}]")
    elif isinstance(node, str) and _INTERP.match(node):
        out.append(f"{path}={node}")
    return out


def _split_sweep_value(val: str) -> list[str]:
    """Split a Hydra-style choice sweep ``a,b,c`` at top-level commas only
    (commas inside ``[...]``/``{...}`` belong to a single YAML value)."""
    parts, depth, cur = [], 0, []
    for ch in val:
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def expand_multirun(overrides: list[str]) -> list[list[str]]:
    """Cartesian product of comma-sweep overrides: ``["lr=1e-4,3e-4",
    "seed=0"]`` -> two jobs (a Hydra-style basic sweeper, ``-m`` on the
    training CLIs)."""
    import itertools

    axes = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        axes.append([f"{key}={v}" for v in _split_sweep_value(val)])
    return [list(combo) for combo in itertools.product(*axes)] if axes else [[]]


def make_run_dir(base: str, multirun: bool = False, job: Optional[int] = None,
                 tags: Optional[list] = None, timestamp: Optional[str] = None) -> Path:
    """Per-run output directory, Hydra-layout: ``<base>/runs/<ts>[_<tags>]``
    or ``<base>/multiruns/<ts>/<job>``."""
    import datetime

    ts = timestamp or datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    if tags:
        ts += "_" + "-".join(str(t) for t in tags)
    d = Path(base) / ("multiruns" if multirun else "runs") / ts
    if multirun:
        d = d / str(job)
    # second-resolution timestamps collide when two runs launch together;
    # claim the directory atomically and retry with a counter suffix
    candidate = d
    for attempt in range(1, 1000):
        try:
            candidate.mkdir(parents=True, exist_ok=False)
            return candidate
        except FileExistsError:
            candidate = d.with_name(f"{d.name}_{attempt}")
    raise RuntimeError(f"could not create a unique run dir under {d.parent}")


def get_metric_value(metric_dict: dict, metric_name: Optional[str]):
    """Retrieve the metric a sweep optimizes; None when unset."""
    if not metric_name:
        return None
    if metric_name not in metric_dict:
        raise KeyError(
            f"optimized_metric {metric_name!r} not in metrics {sorted(metric_dict)}")
    v = metric_dict[metric_name]
    return float(v) if v is not None else None


def load_config(path: str, overrides: Optional[list[str]] = None) -> Config:
    """Compose a task config: base file -> group defaults -> overrides."""
    path = Path(path)
    config_dir = path.parent
    raw = yaml.safe_load(path.read_text()) or {}

    defaults = raw.pop("defaults", {}) or {}
    merged: dict = {}

    # group-swap overrides (``section=name``) change which file loads
    overrides = list(overrides or [])
    group_over = {}
    dot_over = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if "." not in key and key in defaults:
            group_over[key] = val
        else:
            dot_over.append((key, val))

    for section, name in {**defaults, **group_over}.items():
        # group files resolve relative to the config, walking up so
        # experiment overlays in subdirectories share the root groups
        for root in (config_dir, config_dir.parent, config_dir.parent.parent):
            group_file = root / section / f"{name}.yaml"
            if group_file.exists():
                break
        merged[section] = yaml.safe_load(group_file.read_text()) or {}

    merged = _deep_merge(merged, raw)

    for key, val in dot_over:
        parts = key.split(".")
        cur = merged
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _parse_value(val)

    # iterate to a fixpoint: a ${ref} may point at a key whose value is
    # itself an interpolation (single-pass left the literal '${...}' string
    # in place); the depth cap turns reference cycles into a clear error
    for _ in range(10):
        resolved = _resolve_interpolations(merged, merged)
        if resolved == merged:
            break
        merged = resolved
    else:
        raise ValueError("config interpolation did not converge in 10 passes "
                         "(circular ${...} references?)")
    # a direct self-reference (a: ${a}) resolves to an IDENTICAL tree in one
    # pass, so the fixpoint loop exits "converged" with the literal string
    # still in place — scan leaves and raise instead of shipping '${a}'
    leftovers = _find_unresolved(merged)
    if leftovers:
        raise ValueError("unresolved config interpolation(s): "
                         + ", ".join(sorted(leftovers))
                         + " (circular ${...} self-reference?)")
    return Config.wrap(merged)


# keys of a model config that its trainer reads itself, not the network
TRAINER_MODEL_KEYS = ("mode", "strict_parity")


def network_config(model_cfg):
    """The ``NetworkConfig`` of a config's ``model`` section. Keys the port's
    network does not have are dropped with a warning that names them, apart
    from those the trainer reads itself (``TRAINER_MODEL_KEYS``)."""
    import dataclasses

    from packppi_torch.models import NetworkConfig
    from packppi_torch.utils.logging import get_logger

    fields = {f.name for f in dataclasses.fields(NetworkConfig)}
    dropped = sorted(k for k in model_cfg if k not in fields and k not in TRAINER_MODEL_KEYS)
    if dropped:
        get_logger(__name__).warning(
            f"model config keys not used by the port's network: {', '.join(dropped)}")
    return NetworkConfig(**{k: model_cfg[k] for k in fields if k in model_cfg})
