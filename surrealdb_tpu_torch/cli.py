"""Command-line interface.

Role of the reference's clap CLI (reference: src/cli/mod.rs:1-16 subcommands
start, sql, import, export, ml, isready, upgrade, validate, fix, version).

    python -m surrealdb_tpu_torch start [--bind 127.0.0.1:8000] [--device cuda|cpu]
                                        [--user root --pass root] [--unauthenticated]
                                        [memory | file:///path]
    python -m surrealdb_tpu_torch sql   [--endpoint mem://] [--ns t --db t]
    python -m surrealdb_tpu_torch import <file> --endpoint ... --ns ... --db ...
    python -m surrealdb_tpu_torch export <file> --endpoint ... --ns ... --db ...
    python -m surrealdb_tpu_torch validate <file...>
    python -m surrealdb_tpu_torch isready --endpoint http://...
    python -m surrealdb_tpu_torch version
"""

from __future__ import annotations

import argparse
import sys

from surrealdb_tpu_torch import __version__

_DEVICE_HELP = ("torch device an embedded (mem://, file://) store runs on: cuda, or "
                "cpu for the plain versions; without a card cuda raises")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="surrealdb-tpu")
    sub = ap.add_subparsers(dest="cmd")

    p_start = sub.add_parser("start", help="start the server")
    p_start.add_argument("path", nargs="?", default="memory")
    p_start.add_argument("--bind", "-b", default="127.0.0.1:8000")
    p_start.add_argument("--user", "-u")
    p_start.add_argument("--pass", "-p", dest="password")
    p_start.add_argument("--unauthenticated", action="store_true")
    p_start.add_argument("--web-crt", dest="web_crt", help="TLS certificate (PEM)")
    p_start.add_argument("--web-key", dest="web_key", help="TLS private key (PEM)")
    p_start.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    p_start.add_argument("--profile", action="store_true",
                         help="record timed spans around statements and kernel dispatches")
    p_start.add_argument("--cluster", dest="cluster",
                         help="cluster topology JSON (multi-node sharded serving)")
    p_start.add_argument("--cluster-node", dest="cluster_node",
                         help="this node's id in the topology (overrides the file's \"self\")")
    # capability flags (reference: surreal start --allow-*/--deny-*)
    p_start.add_argument("--allow-all", "-A", dest="allow_all", action="store_const", const="all", default=None)
    p_start.add_argument("--deny-all", dest="deny_all", action="store_const", const="all", default=None)
    p_start.add_argument("--allow-scripting", dest="allow_scripting", action="store_const", const="all", default=None)
    p_start.add_argument("--allow-guests", dest="allow_guests", action="store_const", const="all", default=None)
    p_start.add_argument("--deny-guests", dest="allow_guests", action="store_const", const="none")
    p_start.add_argument("--allow-funcs", dest="allow_funcs", nargs="?", const="all", default=None)
    p_start.add_argument("--deny-funcs", dest="deny_funcs", nargs="?", const="all", default=None)
    p_start.add_argument("--allow-net", dest="allow_net", nargs="?", const="all", default=None)
    p_start.add_argument("--deny-net", dest="deny_net", nargs="?", const="all", default=None)
    p_start.add_argument("--allow-rpc", dest="allow_rpc", nargs="?", const="all", default=None)
    p_start.add_argument("--deny-rpc", dest="deny_rpc", nargs="?", const="all", default=None)
    p_start.add_argument("--allow-http", dest="allow_http", nargs="?", const="all", default=None)
    p_start.add_argument("--deny-http", dest="deny_http", nargs="?", const="all", default=None)

    p_sql = sub.add_parser("sql", help="interactive SurrealQL shell")
    p_sql.add_argument("--endpoint", "-e", default="mem://")
    p_sql.add_argument("--ns", default=None)
    p_sql.add_argument("--db", default=None)
    p_sql.add_argument("--user", "-u")
    p_sql.add_argument("--pass", "-p", dest="password")
    p_sql.add_argument("--pretty", action="store_true")
    p_sql.add_argument("--device", default="cuda", help=_DEVICE_HELP)

    p_imp = sub.add_parser("import", help="import a .surql file")
    p_imp.add_argument("file")
    for p in (p_imp,):
        p.add_argument("--endpoint", "-e", default="mem://")
        p.add_argument("--device", default="cuda", help=_DEVICE_HELP)
        p.add_argument("--ns", required=True)
        p.add_argument("--db", required=True)
        p.add_argument("--user", "-u")
        p.add_argument("--pass", "-p", dest="password")

    p_exp = sub.add_parser("export", help="export to a .surql file")
    p_exp.add_argument("file", nargs="?", default="-")
    p_exp.add_argument("--endpoint", "-e", default="mem://")
    p_exp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    p_exp.add_argument("--ns", required=True)
    p_exp.add_argument("--db", required=True)
    p_exp.add_argument("--user", "-u")
    p_exp.add_argument("--pass", "-p", dest="password")

    p_ml = sub.add_parser("ml", help="import/export ML models")
    ml_sub = p_ml.add_subparsers(dest="ml_cmd")
    p_mli = ml_sub.add_parser("import", help="import a JSON model spec")
    p_mli.add_argument("file")
    p_mle = ml_sub.add_parser("export", help="export a model spec as JSON")
    p_mle.add_argument("name")
    p_mle.add_argument("model_version", nargs="?", default="")
    p_mle.add_argument("file", nargs="?", default="-")
    for p in (p_mli, p_mle):
        p.add_argument("--endpoint", "-e", default="mem://")
        p.add_argument("--device", default="cuda", help=_DEVICE_HELP)
        p.add_argument("--ns", required=True)
        p.add_argument("--db", required=True)
        p.add_argument("--user", "-u")
        p.add_argument("--pass", "-p", dest="password")

    p_val = sub.add_parser("validate", help="parse-check SurrealQL files")
    p_val.add_argument("files", nargs="+")

    p_ready = sub.add_parser("isready", help="check a server is responding")
    p_ready.add_argument("--endpoint", "-e", default="http://127.0.0.1:8000")

    p_fix = sub.add_parser("fix", help="repair a damaged file datastore")
    p_fix.add_argument("path")

    p_up = sub.add_parser("upgrade", help="migrate a file datastore to the current storage version")
    p_up.add_argument("path")

    sub.add_parser("version", help="print version")

    args = ap.parse_args(argv)
    if args.cmd is None:
        ap.print_help()
        return 1
    return {
        "start": _start,
        "sql": _sql,
        "import": _import,
        "export": _export,
        "ml": _ml,
        "validate": _validate,
        "isready": _isready,
        "fix": _fix,
        "upgrade": _upgrade,
        "version": _version,
    }[args.cmd](args)


def _version(args) -> int:
    print(f"surrealdb-tpu {__version__}")
    return 0


def _start(args) -> int:
    from surrealdb_tpu_torch.net.server import serve
    from surrealdb_tpu_torch.dbs.session import Session

    from surrealdb_tpu_torch.dbs.capabilities import from_env_and_args

    from surrealdb_tpu_torch import cnf

    if getattr(args, "profile", False) or cnf.PROFILE:
        from surrealdb_tpu_torch import telemetry

        telemetry.enable(True)

    cluster_config = None
    if getattr(args, "cluster", None):
        from surrealdb_tpu_torch.cluster import load_config

        cluster_config = load_config(args.cluster, getattr(args, "cluster_node", None))

    host, _, port = args.bind.partition(":")
    srv = serve(
        args.path, host or "127.0.0.1", int(port or 8000),
        auth_enabled=not args.unauthenticated,
        capabilities=from_env_and_args(args),
        tls_cert=getattr(args, "web_crt", None),
        tls_key=getattr(args, "web_key", None),
        cluster_config=cluster_config,
        device=args.device,
    )
    if cluster_config is not None:
        print(
            f"cluster node {cluster_config.node_id!r}: "
            f"{len(cluster_config.nodes)} member(s), {cluster_config.vnodes} vnodes",
            file=sys.stderr,
        )
    if args.user and args.password:
        from surrealdb_tpu_torch.sql.value import format_value

        srv.httpd.RequestHandlerClass.ds.execute(
            f"DEFINE USER {args.user} ON ROOT PASSWORD {format_value(args.password)} ROLES OWNER;",
            Session.owner(None, None),
        )
    print(f"Started surrealdb-tpu on {srv.url} (storage: {args.path})", file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


def _connect(args):
    from surrealdb_tpu_torch.sdk import Surreal

    remote = args.endpoint.split("://", 1)[0].lower() in ("http", "https", "ws", "wss")
    db = Surreal(args.endpoint) if remote else Surreal(args.endpoint, device=args.device)
    if args.user and args.password:
        db.signin(user=args.user, password=args.password)
    if args.ns or args.db:
        db.use(args.ns, args.db)
    return db


def _sql(args) -> int:
    from surrealdb_tpu_torch.sql.value import format_value

    db = _connect(args)
    print(f"surrealdb-tpu {__version__} — interactive shell (exit with ^D)", file=sys.stderr)
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not line.strip():
            continue
        try:
            for resp in db.query(line):
                status = resp.get("status")
                body = resp.get("result")
                if status == "OK":
                    print(format_value(body, pretty=args.pretty))
                else:
                    print(f"ERR: {body}", file=sys.stderr)
        except Exception as e:
            print(f"ERR: {e}", file=sys.stderr)


def _import(args) -> int:
    db = _connect(args)
    with open(args.file) as f:
        db.import_(f.read())
    print("import completed", file=sys.stderr)
    return 0


def _export(args) -> int:
    db = _connect(args)
    dump = db.export()
    if args.file == "-":
        sys.stdout.write(dump)
    else:
        with open(args.file, "w") as f:
            f.write(dump)
    return 0


def _ml(args) -> int:
    """`surrealdb-tpu ml import|export` (reference: src/cli/ml/)."""
    import json

    if args.ml_cmd == "import":
        db = _connect(args)
        with open(args.file, "rb") as f:
            raw = f.read()
        if args.file.endswith(".surml") or raw[:1] not in (b"{", b"["):
            entry = db.import_surml(raw)
        else:
            entry = db.import_model(json.loads(raw))
        print(f"model ml::{entry['name']}<{entry['version']}> stored", file=sys.stderr)
        return 0
    if args.ml_cmd == "export":
        db = _connect(args)
        spec = db.export_model(args.name, args.model_version)
        text = json.dumps(spec)
        if args.file == "-":
            sys.stdout.write(text)
        else:
            with open(args.file, "w") as f:
                f.write(text)
        return 0
    print("usage: surrealdb-tpu ml {import,export} ...", file=sys.stderr)
    return 1


def _fix(args) -> int:
    from surrealdb_tpu_torch.kvs.file import repair

    try:
        stats = repair(args.path)
    except (ValueError, OSError) as e:
        print(f"fix failed: {e}", file=sys.stderr)
        return 1
    print(
        f"{args.path}: repaired — {stats['keys']} keys, "
        f"{stats['wal_frames']} WAL frames replayed, "
        f"{stats['snapshot_dropped_bytes']} torn snapshot bytes dropped"
    )
    return 0


def _upgrade(args) -> int:
    from surrealdb_tpu_torch.kvs.file import upgrade

    try:
        stats = upgrade(args.path)
    except (ValueError, OSError) as e:
        print(f"upgrade failed: {e}", file=sys.stderr)
        return 1
    print(
        f"{args.path}: storage version {stats['from_version']} -> "
        f"{stats['to_version']} ({stats['keys']} keys)"
    )
    return 0


def _validate(args) -> int:
    from surrealdb_tpu_torch.syn import parse_query
    from surrealdb_tpu_torch.err import ParseError

    bad = 0
    for path in args.files:
        try:
            with open(path) as f:
                parse_query(f.read())
            print(f"{path}: OK")
        except ParseError as e:
            print(f"{path}: {e}", file=sys.stderr)
            bad += 1
    return 1 if bad else 0


def _isready(args) -> int:
    import http.client
    from urllib.parse import urlparse

    u = urlparse(args.endpoint)
    try:
        conn = http.client.HTTPConnection(u.hostname, u.port or 8000, timeout=5)
        conn.request("GET", "/health")
        ok = conn.getresponse().status == 200
    except OSError:
        ok = False
    print("OK" if ok else "not ready")
    return 0 if ok else 1
