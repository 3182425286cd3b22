"""Minimal synchronous RESP client.

Used by the integration tests and the bench harness to drive the data
plane the way the reference drives Garnet with StackExchange.Redis
(ref: tests use SE.Redis; src/Pyrope.Benchmarks/Program.cs:265-396 issues
VEC.UPSERT / VEC.SEARCH over pooled connections). Standalone on purpose —
the environment ships no redis-py.
"""

from __future__ import annotations

import socket
from typing import Union

Reply = Union[str, bytes, int, None, list]


class RespError(Exception):
    def __init__(self, message: str):
        super().__init__(message)
        self.code = message.split(" ", 1)[0]


class RespClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 6379, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        self._out: list[bytes] = []  # queued pipelined commands (see send)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- wire ------------------------------------------------------------

    def _encode(self, *args: "bytes | str | int | float") -> bytes:
        out = b"*" + str(len(args)).encode() + b"\r\n"
        for a in args:
            if isinstance(a, (int, float)):
                a = str(a)
            if isinstance(a, str):
                a = a.encode()
            out += b"$" + str(len(a)).encode() + b"\r\n" + a + b"\r\n"
        return out

    def _send(self, *args: "bytes | str | int | float") -> None:
        self._sock.sendall(self._encode(*args))

    def _readline(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _readn(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed connection")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    def _read_reply(self) -> Reply:
        line = self._readline()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RespError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self._readn(n + 2)[:-2]
            try:
                return data.decode()
            except UnicodeDecodeError:
                return data
        if t == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RespError(f"ERR bad reply type: {line!r}")

    def execute(self, *args) -> Reply:
        self._send(*args)
        return self._read_reply()

    # ---- pipelining ---------------------------------------------------------

    def send(self, *args) -> None:
        """Queue one command without waiting for its reply (RESP
        pipelining). Pair each send with a later read_reply() in order —
        N outstanding commands amortize the per-op round trip and syscall
        cost that dominates per-row ingest on a single-core host. Queued
        commands buffer locally and hit the socket in ONE sendall at the
        next read_reply()/flush() (one tiny send syscall per command was
        measurable GIL/syscall churn at pipeline depth 64)."""
        self._out.append(self._encode(*args))

    def flush(self) -> None:
        """Send all queued pipelined commands in one syscall."""
        if self._out:
            data = b"".join(self._out)
            self._out.clear()
            self._sock.sendall(data)

    def read_reply(self) -> Reply:
        """Read the next pipelined reply (FIFO order)."""
        self.flush()
        return self._read_reply()

    # ---- convenience -------------------------------------------------------

    def ping(self) -> bool:
        return self.execute("PING") == "PONG"

    def auth(self, tenant: str, key: str) -> bool:
        return self.execute("AUTH", f"{tenant}:{key}") == "OK"

    def vec_add(self, tenant: str, index: str, id: str, payload: bytes, *extra) -> str:
        return self.execute("VEC.ADD", tenant, index, id, "VECTOR", payload, *extra)

    def vec_upsert(self, tenant: str, index: str, id: str, payload: bytes, *extra) -> str:
        return self.execute("VEC.UPSERT", tenant, index, id, "VECTOR", payload, *extra)

    def vec_del(self, tenant: str, index: str, id: str, *extra) -> str:
        return self.execute("VEC.DEL", tenant, index, id, *extra)

    def vec_search(self, tenant: str, index: str, payload: bytes, top_k: int = 10, *extra):
        return self.execute(
            "VEC.SEARCH", tenant, index, "TOPK", top_k, "VECTOR", payload, *extra
        )

    def vec_stats(self, tenant: str, index: str) -> dict:
        flat = self.execute("VEC.STATS", tenant, index)
        out = {}
        for i in range(0, len(flat), 2):
            out[flat[i]] = flat[i + 1]
        return out
