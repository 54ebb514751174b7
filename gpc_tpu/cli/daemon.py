"""Warm-process daemon for the gp/ivm/gplvm CLIs.

The reference binaries pay ~40 ms of process startup; a JAX CLI pays seconds
of interpreter + `import jax` plus trace/lower time on EVERY invocation —
the dominant cost at tutorial sizes.  This
daemon keeps one warm Python/JAX process alive behind a unix socket; the
client (stdlib-only, no jax import — ~50 ms) forwards argv and receives the
command's captured stdout/stderr when it completes (output is buffered, not
incremental), so repeated CLI runs reuse the live jit caches in-process.

Usage:
    GPC_TPU_DAEMON=1 bin/gp learn ...      # bin wrappers auto-dispatch
    python -m gpc_tpu.cli.daemon run gp learn ...   # explicit client
    python -m gpc_tpu.cli.daemon serve     # foreground server
    python -m gpc_tpu.cli.daemon stop

The daemon is an opt-in convenience for interactive/repeated use and
benchmarking; model files, seeds and outputs are identical to the one-shot
CLIs (each request runs the same `main(argv)` with its own seed handling).

One process per card: a JAX process reserves most of a GPU's memory when it
first uses it, so while the daemon serves, it owns the card, and a one-shot
CLI started beside it on the same card fails for want of memory.  Run every
CLI command on that card through the daemon (GPC_TPU_DAEMON=1 or
`daemon run`) until `daemon stop`.
Protocol: 4-byte big-endian length + JSON {tool, argv, cwd} / {rc, out, err}.
The server exits after GPC_TPU_DAEMON_IDLE seconds (default 900) without a
request.  Requests are handled strictly one at a time.
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import subprocess
import sys
import time

_TOOLS = ("gp", "ivm", "gplvm")


def _sock_path():
    return os.environ.get(
        "GPC_TPU_DAEMON_SOCKET",
        os.path.join(os.path.expanduser("~"), ".cache", "gpc_tpu",
                     "daemon.sock"))


def _send(conn, obj):
    data = json.dumps(obj).encode()
    conn.sendall(struct.pack(">I", len(data)) + data)


def _recv(conn):
    hdr = b""
    while len(hdr) < 4:
        part = conn.recv(4 - len(hdr))
        if not part:
            return None
        hdr += part
    (n,) = struct.unpack(">I", hdr)
    data = b""
    while len(data) < n:
        part = conn.recv(min(65536, n - len(data)))
        if not part:
            return None
        data += part
    return json.loads(data)


# ---------------------------------------------------------------- server --


def _handle(mains, req):
    tool = req.get("tool")
    argv = req.get("argv", [])
    cwd = req.get("cwd")
    if tool not in _TOOLS:
        return {"rc": 2, "out": "", "err": f"unknown tool {tool!r}\n"}
    out, err = io.StringIO(), io.StringIO()
    rc = 0
    prev_cwd = os.getcwd()
    prev_out, prev_err = sys.stdout, sys.stderr
    try:
        if cwd:
            os.chdir(cwd)
        sys.stdout, sys.stderr = out, err
        mains[tool](argv)
    except SystemExit as e:  # ExitError and explicit sys.exit
        code = e.code
        if isinstance(code, str):
            err.write(code + "\n")
            rc = 1
        else:
            rc = int(code or 0)
    except Exception as e:  # noqa: BLE001 — daemon must survive any request
        import traceback
        err.write("".join(traceback.format_exception(e)))
        rc = 1
    finally:
        sys.stdout, sys.stderr = prev_out, prev_err
        os.chdir(prev_cwd)
    return {"rc": rc, "out": out.getvalue(), "err": err.getvalue()}


def serve():
    path = _sock_path()
    # The daemon executes gp/ivm/gplvm with caller-supplied paths, so the
    # socket must not be reachable by other local users (Linux honors file
    # perms on connect()): private dir + 0o600 socket.  The umask tweak is
    # saved/RESTORED around the bind alone, so model files the daemon-routed
    # tools write keep the same permissions as direct CLI runs.
    os.makedirs(os.path.dirname(path), mode=0o700, exist_ok=True)
    if "GPC_TPU_DAEMON_SOCKET" not in os.environ:
        # harden only OUR default ~/.cache dir: a user-supplied socket may
        # live in a shared directory (/tmp) where chmod 0700 would either
        # fail or lock out every other process
        os.chmod(os.path.dirname(path), 0o700)
    # stale-socket recovery: if nothing answers, unlink and rebind
    if os.path.exists(path):
        probe = socket.socket(socket.AF_UNIX)
        try:
            probe.settimeout(2.0)
            probe.connect(path)
            probe.close()
            print(f"daemon already running at {path}", file=sys.stderr)
            return 0
        except OSError:
            os.unlink(path)
        finally:
            probe.close()

    # preload: one warm jax + model stack for every later request
    from gpc_tpu.cli import gp as _gp
    from gpc_tpu.cli import gplvm as _gplvm
    from gpc_tpu.cli import ivm as _ivm
    from gpc_tpu.cli.common import setup_jax
    setup_jax()
    mains = {"gp": _gp.main, "ivm": _ivm.main, "gplvm": _gplvm.main}

    idle = float(os.environ.get("GPC_TPU_DAEMON_IDLE", "900"))
    srv = socket.socket(socket.AF_UNIX)
    old_umask = os.umask(0o077)  # no 0755 window before the chmod below
    try:
        srv.bind(path)
    finally:
        os.umask(old_umask)
    os.chmod(path, 0o600)
    srv.listen(1)
    srv.settimeout(idle)
    try:
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                break  # idle shutdown
            with conn:
                req = _recv(conn)
                if req is None:
                    continue
                if req.get("tool") == "__stop__":
                    _send(conn, {"rc": 0, "out": "", "err": ""})
                    break
                _send(conn, _handle(mains, req))
    finally:
        srv.close()
        if os.path.exists(path):
            os.unlink(path)
    return 0


# ---------------------------------------------------------------- client --


def _connect(path, spawn=True, wait_s=180.0):
    cli = socket.socket(socket.AF_UNIX)
    try:
        cli.connect(path)
        return cli
    except OSError:
        cli.close()
        if not spawn:
            return None
    log = os.path.join(os.path.dirname(path), "daemon.log")
    os.makedirs(os.path.dirname(path), mode=0o700, exist_ok=True)
    with open(log, "ab") as lf:
        subprocess.Popen(
            [sys.executable, "-m", "gpc_tpu.cli.daemon", "serve"],
            stdout=lf, stderr=lf, stdin=subprocess.DEVNULL,
            start_new_session=True)
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        cli = socket.socket(socket.AF_UNIX)
        try:
            cli.connect(path)
            return cli
        except OSError:
            cli.close()
            time.sleep(0.1)
    return None


def client_run(tool, argv):
    path = _sock_path()
    cli = _connect(path)
    if cli is None:
        print("Error: could not start gpc_tpu daemon "
              f"(see {os.path.dirname(path)}/daemon.log)", file=sys.stderr)
        return 3
    with cli:
        _send(cli, {"tool": tool, "argv": list(argv), "cwd": os.getcwd()})
        resp = _recv(cli)
    if resp is None:
        print("Error: gpc_tpu daemon hung up", file=sys.stderr)
        return 3
    sys.stdout.write(resp["out"])
    sys.stderr.write(resp["err"])
    return resp["rc"]


def stop():
    cli = _connect(_sock_path(), spawn=False)
    if cli is None:
        return 0
    with cli:
        _send(cli, {"tool": "__stop__"})
        _recv(cli)
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        return serve()
    if cmd == "stop":
        return stop()
    if cmd == "run":
        if not rest or rest[0] not in _TOOLS:
            print(f"usage: daemon run {{{'|'.join(_TOOLS)}}} args...",
                  file=sys.stderr)
            return 2
        return client_run(rest[0], rest[1:])
    print(f"unknown daemon command {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
