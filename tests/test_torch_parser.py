"""The port's twin of ``tests/test_parser.py``, case for case: the same cases
against ``pyrope_tpu_torch`` on the CPU (``device="cpu"``).

Command-grammar unit tests (ref: VectorCommandParser tests — the write
grammar :171-251 and search grammar :253-367)."""

import json

import numpy as np
import pytest

from pyrope_tpu_torch.server.parser import (
    ParseError,
    parse_delete,
    parse_search,
    parse_stats,
    parse_write,
)


def b(*args):
    return [a if isinstance(a, bytes) else str(a).encode() for a in args]


class TestParseWrite:
    def test_minimal(self):
        r = parse_write(b("t1", "idx", "id1", "VECTOR", "[1,2,3]"))
        assert r.tenant == "t1" and r.index == "idx" and r.id == "id1"
        assert np.allclose(r.vector, [1, 2, 3])

    def test_full_grammar(self):
        r = parse_write(b(
            "t1", "idx", "id1", "VECTOR", "[1,2]",
            "META", '{"lang":"en"}',
            "TAGS", '["a","b"]',
            "NUMERIC_FIELDS", '{"price": 9.5}',
            "API_KEY", "sek",
        ))
        assert r.meta == {"lang": "en"}
        assert r.tags == ("a", "b")
        assert r.numeric_fields == {"price": 9.5}
        assert r.api_key == "sek"

    def test_csv_tags(self):
        r = parse_write(b("t", "i", "x", "VECTOR", "[1]", "TAGS", "a, b ,c"))
        assert r.tags == ("a", "b", "c")

    def test_errors(self):
        with pytest.raises(ParseError):
            parse_write(b("t", "i", "x"))  # too short
        with pytest.raises(ParseError):
            parse_write(b("t", "i", "x", "NOTVECTOR", "[1]"))
        with pytest.raises(ParseError):
            parse_write(b("t", "i", "x", "VECTOR", "[1]", "META", "{bad"))
        with pytest.raises(ParseError):
            parse_write(b("t", "i", "x", "VECTOR", "[1]", "BOGUS", "y"))


class TestParseSearch:
    def test_explicit_tenant(self):
        r = parse_search(b("t1", "idx", "TOPK", "5", "VECTOR", "[1,2]"))
        assert (r.tenant, r.index, r.top_k) == ("t1", "idx", 5)

    def test_session_tenant_form(self):
        r = parse_search(b("idx", "TOPK", "3", "VECTOR", "[1]"), default_tenant="sess")
        assert (r.tenant, r.index) == ("sess", "idx")
        with pytest.raises(ParseError):
            parse_search(b("idx", "TOPK", "3", "VECTOR", "[1]"), default_tenant=None)

    def test_all_flags(self):
        r = parse_search(b(
            "t", "i", "TOPK", "10", "VECTOR", "[1]",
            "FILTER", "x,y", "WITH_META", "TRACE",
            "REQUEST_ID", "r1", "CACHE_HINT", "force", "API_KEY", "k",
            "MAX_SCANS", "100", "NPROBE", "7", "EF_SEARCH", "64",
        ))
        assert r.filter_tags == ("x", "y")
        assert r.with_meta and r.trace and r.cache_hint_force
        assert r.request_id == "r1" and r.api_key == "k"
        assert (r.options.max_scans, r.options.nprobe, r.options.ef_search) == (100, 7, 64)

    def test_binary_payload(self):
        payload = np.array([1.5, 2.5], "<f4").tobytes()
        r = parse_search(b("t", "i", "TOPK", "1", "VECTOR") + [payload])
        assert np.allclose(r.vector, [1.5, 2.5])

    def test_errors(self):
        with pytest.raises(ParseError):
            parse_search(b("t", "i", "VECTOR", "[1]"))  # no TOPK
        with pytest.raises(ParseError):
            parse_search(b("t", "i", "TOPK", "zero", "VECTOR", "[1]"))
        with pytest.raises(ParseError):
            parse_search(b("t", "i", "TOPK", "0", "VECTOR", "[1]"))
        with pytest.raises(ParseError):
            parse_search(b("t", "i", "TOPK", "5", "VECTOR", "[1]", "JUNK"))


class TestParseDeleteStats:
    def test_delete(self):
        r = parse_delete(b("t", "i", "x", "API_KEY", "k"))
        assert (r.tenant, r.index, r.id, r.api_key) == ("t", "i", "x", "k")
        with pytest.raises(ParseError):
            parse_delete(b("t", "i"))

    def test_stats(self):
        assert parse_stats(b("t", "i")).tenant == "t"
        assert parse_stats(b("i"), default_tenant="s").tenant == "s"
        with pytest.raises(ParseError):
            parse_stats(b("i"))
