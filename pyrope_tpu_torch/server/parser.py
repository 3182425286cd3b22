"""VEC.* command-argument parsing.

Rebuild of the reference's ``VectorCommandParser``
(ref: Extensions/VectorCommandParser.cs): write grammar
``VEC.ADD tenant index id VECTOR <payload> [META json] [TAGS json|csv]
[NUMERIC_FIELDS json] [API_KEY k]`` (:171-251) and search grammar
``VEC.SEARCH [tenant] index TOPK k VECTOR <payload> [FILTER tags]
[WITH_META] [TRACE] [REQUEST_ID r] [CACHE_HINT force] [API_KEY k]``
(:253-367) plus engine knobs NPROBE/EF_SEARCH/MAX_SCANS (the reference
carries these in SearchOptions). Vector payloads may be JSON, CSV, or raw
little-endian float32 (Utils/VectorParsing.cs) — handled by
``pyrope_tpu_torch.utils.parsing``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from pyrope_tpu_torch.types import SearchOptions
from pyrope_tpu_torch.utils.parsing import parse_vector


class ParseError(ValueError):
    pass


@dataclasses.dataclass
class WriteRequest:
    tenant: str
    index: str
    id: str
    vector: np.ndarray
    meta: Optional[dict] = None
    tags: tuple[str, ...] = ()
    numeric_fields: Optional[dict[str, float]] = None
    api_key: Optional[str] = None


@dataclasses.dataclass
class DeleteRequest:
    tenant: str
    index: str
    id: str
    api_key: Optional[str] = None


@dataclasses.dataclass
class SearchRequest:
    tenant: str
    index: str
    vector: np.ndarray
    top_k: int = 10
    filter_tags: tuple[str, ...] = ()
    with_meta: bool = False
    trace: bool = False
    request_id: str = ""
    cache_hint_force: bool = False
    api_key: Optional[str] = None
    options: Optional[SearchOptions] = None


@dataclasses.dataclass
class StatsRequest:
    tenant: str
    index: str
    api_key: Optional[str] = None


def _dec(b: bytes) -> str:
    return b.decode("utf-8", "replace")


def _parse_tags(raw: bytes) -> tuple[str, ...]:
    """TAGS accepts a JSON array or CSV (ref :214-228)."""
    s = _dec(raw).strip()
    if s.startswith("["):
        try:
            arr = json.loads(s)
            return tuple(str(t) for t in arr)
        except json.JSONDecodeError as e:
            raise ParseError(f"bad TAGS json: {e}")
    return tuple(t.strip() for t in s.split(",") if t.strip())


def parse_write(args: list[bytes]) -> WriteRequest:
    if len(args) < 5:
        raise ParseError("usage: VEC.ADD tenant index id VECTOR <payload> [...]")
    tenant, index, id_ = _dec(args[0]), _dec(args[1]), _dec(args[2])
    if _dec(args[3]).upper() != "VECTOR":
        raise ParseError("expected VECTOR keyword")
    vector = parse_vector(args[4])
    req = WriteRequest(tenant, index, id_, vector)
    i = 5
    while i < len(args):
        kw = _dec(args[i]).upper()
        if kw == "META" and i + 1 < len(args):
            try:
                req.meta = json.loads(_dec(args[i + 1]))
            except json.JSONDecodeError as e:
                raise ParseError(f"bad META json: {e}")
            i += 2
        elif kw == "TAGS" and i + 1 < len(args):
            req.tags = _parse_tags(args[i + 1])
            i += 2
        elif kw == "NUMERIC_FIELDS" and i + 1 < len(args):
            try:
                nf = json.loads(_dec(args[i + 1]))
                req.numeric_fields = {str(k): float(v) for k, v in nf.items()}
            except (json.JSONDecodeError, AttributeError, TypeError, ValueError) as e:
                raise ParseError(f"bad NUMERIC_FIELDS json: {e}")
            i += 2
        elif kw == "API_KEY" and i + 1 < len(args):
            req.api_key = _dec(args[i + 1])
            i += 2
        else:
            raise ParseError(f"unexpected token: {kw}")
    return req


def parse_delete(args: list[bytes]) -> DeleteRequest:
    if len(args) < 3:
        raise ParseError("usage: VEC.DEL tenant index id [API_KEY k]")
    req = DeleteRequest(_dec(args[0]), _dec(args[1]), _dec(args[2]))
    i = 3
    while i < len(args):
        kw = _dec(args[i]).upper()
        if kw == "API_KEY" and i + 1 < len(args):
            req.api_key = _dec(args[i + 1])
            i += 2
        else:
            raise ParseError(f"unexpected token: {kw}")
    return req


def parse_search(args: list[bytes], default_tenant: Optional[str] = None) -> SearchRequest:
    """Accepts ``VEC.SEARCH tenant index TOPK …`` and the reference's
    session-authenticated ``VEC.SEARCH index TOPK …`` form (tenant from
    the AUTH session, ref :253-270)."""
    # TOPK can only be the keyword at positions 1 or 2; prefer the
    # explicit-tenant form so tenants/indexes literally named "topk" parse
    upper = [(_dec(a).upper() if len(a) < 32 else "") for a in args]
    if len(upper) > 2 and upper[2] == "TOPK":
        k_at = 2
        tenant, index = _dec(args[0]), _dec(args[1])
    elif len(upper) > 1 and upper[1] == "TOPK":
        k_at = 1
        if default_tenant is None:
            raise ParseError("tenant required (no session AUTH)")
        tenant, index = default_tenant, _dec(args[0])
    else:
        raise ParseError("usage: VEC.SEARCH [tenant] index TOPK k VECTOR <payload>")
    if k_at + 3 >= len(args) + 1 or len(args) < k_at + 4:
        raise ParseError("missing TOPK value or VECTOR")
    try:
        top_k = int(_dec(args[k_at + 1]))
    except ValueError:
        raise ParseError("TOPK must be an integer")
    if top_k <= 0 or top_k > 10_000:
        raise ParseError("TOPK out of range")
    if upper[k_at + 2] != "VECTOR":
        raise ParseError("expected VECTOR keyword")
    vector = parse_vector(args[k_at + 3])
    req = SearchRequest(tenant, index, vector, top_k)

    max_scans = nprobe = ef_search = None
    i = k_at + 4
    while i < len(args):
        kw = upper[i] or _dec(args[i]).upper()
        if kw == "FILTER" and i + 1 < len(args):
            req.filter_tags = _parse_tags(args[i + 1])
            i += 2
        elif kw == "WITH_META":
            req.with_meta = True
            i += 1
        elif kw == "TRACE":
            req.trace = True
            i += 1
        elif kw == "REQUEST_ID" and i + 1 < len(args):
            req.request_id = _dec(args[i + 1])
            i += 2
        elif kw == "CACHE_HINT" and i + 1 < len(args):
            req.cache_hint_force = _dec(args[i + 1]).lower() == "force"
            i += 2
        elif kw == "API_KEY" and i + 1 < len(args):
            req.api_key = _dec(args[i + 1])
            i += 2
        elif kw == "MAX_SCANS" and i + 1 < len(args):
            max_scans = int(_dec(args[i + 1]))
            i += 2
        elif kw == "NPROBE" and i + 1 < len(args):
            nprobe = int(_dec(args[i + 1]))
            i += 2
        elif kw == "EF_SEARCH" and i + 1 < len(args):
            ef_search = int(_dec(args[i + 1]))
            i += 2
        else:
            raise ParseError(f"unexpected token: {kw}")
    if max_scans is not None or nprobe is not None or ef_search is not None:
        req.options = SearchOptions(max_scans=max_scans, nprobe=nprobe, ef_search=ef_search)
    return req


def parse_stats(args: list[bytes], default_tenant: Optional[str] = None) -> StatsRequest:
    api_key = None
    if len(args) >= 2 and _dec(args[-2]).upper() == "API_KEY":
        api_key = _dec(args[-1])
        args = args[:-2]
    if len(args) == 2:
        return StatsRequest(_dec(args[0]), _dec(args[1]), api_key)
    if len(args) == 1 and default_tenant is not None:
        return StatsRequest(default_tenant, _dec(args[0]), api_key)
    raise ParseError("usage: VEC.STATS [tenant] index [API_KEY k]")
