"""Interactive admin REPL (reference: `weed shell`, shell/commands.go).

The port runs every command of the JAX package's shell (see ``HELP``), with
its flags: the EC and volume-maintenance commands over the master and the
volume servers, and with ``-filer`` the filer's ``fs.*``, ``bucket.*``,
``volume.fsck``, ``query`` and ``trace``; ``remote.dlq`` reads the
replication dead-letter queues on the local disk.
"""

from __future__ import annotations

import json
import shlex
import urllib.error

from ..util.retry import READ_POLICY, RetryError, retry_call
from . import commands as C
from .commands import CommandEnv

HELP = """commands:
  cluster.status                      show topology
  volume.list                         list volumes on all servers
  volume.vacuum [-garbageThreshold=X] compact garbage volumes
  volume.delete -volumeId=N           delete a volume everywhere
  volume.mark -volumeId=N -readonly|-writable [-node=H]  flip the write gate
  volume.mark.readonly -volumeId=N    seal a volume
  volume.fix.replication              re-replicate under-replicated volumes
  volume.move -volumeId=N -target=host:port [-source=host:port]
  volume.copy -volumeId=N -target=host:port [-source=host:port]
  volume.mount|volume.unmount -volumeId=N -node=host:port
  volume.configure.replication -volumeId=N -replication=XYZ
  volume.tier.upload -volumeId=N [-backend=s3.default|-endpoint=..] [-bucket=B]
  volume.tier.download -volumeId=N
  volume.balance [-collection=C] [-force=true] [-heat]  plan (and apply) even
                 spread; -heat moves replicas off hot nodes (EWMA heat)
  volumeServer.evacuate -node=host:port         drain a server
  volumeServer.leave -node=host:port            deregister a server now
  volume.fsck [-apply=true]                     find orphan needles vs filer
  ec.encode -volumeId=N[,M..] [-collection=C] [-fleet]
                 erasure-code + spread volume(s); -fleet hands the batch to
                 the master's scheduler, which fans generate jobs across
                 the mesh-registered volume servers in parallel
  ec.decode -volumeId=N [-collection=C]   turn an EC volume back to normal
  ec.rebuild -volumeId=N                  rebuild missing shards
  ec.balance                              even out shard spread
  collection.list | collection.delete -collection=C
  fs.cd PATH | fs.pwd | fs.ls [PATH] | fs.du [PATH] | fs.tree [PATH]
  fs.cat FILE | fs.mv SRC DST | fs.meta.cat FILE
  fs.meta.save -o=FILE [PATH] | fs.meta.load -i=FILE | fs.meta.notify [PATH]
  fs.configure [-locationPrefix=/p/ -collection=C -replication=XYZ
                -ttl=T -apply=true|-delete=true]
  bucket.list | bucket.create -name=B | bucket.delete -name=B
  query -path=FILE [-input=csv|json] 'SELECT ... FROM s3object [WHERE ...]'
  remote.dlq -dir=DLQ_DIR [-direction=a_to_b] [-replay]
                 list (or -replay) events parked by cross-cluster sync
  trace TRACE_ID          assemble one distributed trace (filer→assign→
                 volume span tree with per-hop timings) from every
                 daemon's /debug/traces ring
  lifecycle.status        cycle counters, interlock state, last plan, and
                 journal recovery summary of the master's lifecycle autopilot
  lifecycle.pause | lifecycle.resume  halt / restart autopilot scheduling
                 (in-flight actions finish; they are staged-commit safe)
  lock | unlock
  help | exit
"""

def _flags(parts: list[str]) -> dict[str, str]:
    out = {}
    for p in parts:
        if p.startswith("-") and "=" in p:
            k, v = p[1:].split("=", 1)
            out[k] = v
        elif p.startswith("-") and len(p) > 1:
            out[p[1:]] = "true"  # bare boolean flag (-readonly, -fleet)
    return out


# read-only commands the failover wrapper may silently re-run: they mutate
# nothing, so replaying them after a mid-flight failure is always safe. A
# mutating command (ec.encode's multi-step spread, volume.delete, ...) may
# have PARTIALLY executed before the connection error — auto-retrying would
# re-issue completed steps, so those surface the error with the new master.
_RETRY_SAFE = {
    "help", "cluster.status", "volume.list", "collection.list",
    "bucket.list", "fs.ls", "fs.du", "fs.tree", "fs.cat", "fs.pwd",
    "fs.meta.cat", "query", "trace", "lifecycle.status",
}


def run_command_with_failover(env: CommandEnv, line: str) -> object:
    """run_command with mid-session master failover: on a connection-level
    failure the master is re-resolved to a verified-reachable seed;
    read-only commands are then retried automatically, mutating ones
    re-raise with the failover noted (the operator re-runs knowingly)."""
    try:
        return run_command(env, line)
    except (
        FileNotFoundError,
        PermissionError,
        IsADirectoryError,
        NotADirectoryError,
    ):
        # local filesystem failures are not a failover
        raise
    except (OSError, urllib.error.URLError) as e:
        # the rest of the OSError family the HTTP layer raises is
        # connection-level: refused, reset, unreachable, DNS, timeouts
        cmd = (line.strip().split() or [""])[0]
        if not env.re_resolve_master():
            raise
        if cmd in _RETRY_SAFE:
            # bounded-backoff re-run: the freshly-resolved master may still
            # be settling, so pace a few attempts
            try:
                return retry_call(run_command, env, line, policy=READ_POLICY)
            except RetryError as e2:
                raise e2.last from e
        raise RuntimeError(
            f"{e} — master failed over to {env.master}; the command may "
            f"have partially executed, re-run it deliberately"
        ) from e


def run_command(env: CommandEnv, line: str) -> object:
    parts = shlex.split(line.strip())
    if not parts:
        return None
    cmd, flags = parts[0], _flags(parts[1:])
    args = [p for p in parts[1:] if not p.startswith("-")]
    if cmd in ("exit", "quit"):
        raise EOFError
    if cmd == "help":
        return HELP
    if cmd == "cluster.status":
        return C.cluster_status(env)
    if cmd == "volume.list":
        return C.volume_list(env)
    if cmd == "volume.vacuum":
        return C.volume_vacuum(env, float(flags.get("garbageThreshold", 0.3)))
    if cmd == "volume.fix.replication":
        return C.volume_fix_replication(env)
    if cmd == "volume.move":
        return C.volume_move(env, int(flags["volumeId"]), flags["target"],
                             flags.get("source", ""))
    if cmd == "volume.copy":
        return C.volume_copy(env, int(flags["volumeId"]), flags["target"],
                             flags.get("source", ""))
    if cmd == "volume.mount":
        return C.volume_mount(env, int(flags["volumeId"]), flags["node"])
    if cmd == "volume.unmount":
        return C.volume_unmount(env, int(flags["volumeId"]), flags["node"])
    if cmd == "volume.configure.replication":
        return C.volume_configure_replication(env, int(flags["volumeId"]),
                                              flags["replication"])
    if cmd == "volume.balance":
        # plan only unless -force (command_volume_balance.go's opt-in);
        # -heat balances EWMA heat instead of volume counts
        return C.volume_balance(env, flags.get("collection"),
                                apply=flags.get("force") == "true",
                                heat=flags.get("heat") == "true")
    if cmd == "volumeServer.evacuate":
        return C.volume_server_evacuate(env, flags["node"])
    if cmd == "volumeServer.leave":
        return C.volume_server_leave(env, flags["node"])
    if cmd == "volume.tier.upload":
        return C.volume_tier_upload(env, int(flags["volumeId"]), flags.get("endpoint", ""),
                                    flags.get("bucket", "tier"),
                                    keep_local=flags.get("keepLocal") == "true",
                                    backend=flags.get("backend", ""))
    if cmd == "volume.tier.download":
        return C.volume_tier_download(env, int(flags["volumeId"]))
    if cmd == "lifecycle.status":
        return C.lifecycle_status(env)
    if cmd == "lifecycle.pause":
        return C.lifecycle_pause(env)
    if cmd == "lifecycle.resume":
        return C.lifecycle_resume(env)
    if cmd == "volume.delete":
        C.volume_delete(env, int(flags["volumeId"]))
        return "ok"
    if cmd == "volume.mark.readonly":
        C.volume_mark_readonly(env, int(flags["volumeId"]))
        return "ok"
    if cmd == "volume.mark":
        # reference spelling (command_volume_mark.go): -readonly|-writable
        writable = "writable" in flags
        if not writable and "readonly" not in flags:
            raise ValueError("use -readonly or -writable")
        C.volume_mark(env, int(flags["volumeId"]), writable,
                      node=flags.get("node", ""))
        return "ok"
    if cmd == "ec.encode":
        vids = [int(v) for v in flags["volumeId"].split(",") if v.strip()]
        if flags.get("fleet") == "true":
            return C.ec_encode_fleet(env, vids, flags.get("collection", ""))
        if len(vids) != 1:
            raise ValueError("multiple -volumeId values require -fleet")
        return C.ec_encode(env, vids[0], flags.get("collection", ""))
    if cmd == "ec.decode":
        return C.ec_decode(
            env, int(flags["volumeId"]), flags.get("collection", "")
        )
    if cmd == "ec.rebuild":
        return C.ec_rebuild(
            env, int(flags["volumeId"]), flags.get("collection", "")
        )
    if cmd == "ec.balance":
        return C.ec_balance(env, flags.get("collection", ""))
    if cmd == "collection.list":
        return C.collection_list(env)
    if cmd == "collection.delete":
        return C.collection_delete(env, flags["collection"])
    if cmd == "volume.fsck":
        return C.volume_fsck(env, env.filer, apply=flags.get("apply") == "true")
    if cmd == "fs.cd":
        return C.fs_cd(env, args[0] if args else "/")
    if cmd == "fs.pwd":
        return C.fs_pwd(env)
    if cmd == "fs.ls":
        return C.fs_ls(env, args[0] if args else None)
    if cmd == "fs.du":
        return C.fs_du(env, args[0] if args else None)
    if cmd == "fs.tree":
        return C.fs_tree(env, args[0] if args else None)
    if cmd == "fs.cat":
        return C.fs_cat(env, args[0])
    if cmd == "fs.mv":
        return C.fs_mv(env, args[0], args[1])
    if cmd == "fs.meta.cat":
        return C.fs_meta_cat(env, args[0])
    if cmd == "fs.meta.save":
        return C.fs_meta_save(env, flags["o"], args[0] if args else None)
    if cmd == "fs.meta.load":
        return C.fs_meta_load(env, flags["i"])
    if cmd == "fs.meta.notify":
        return C.fs_meta_notify(env, args[0] if args else None)
    if cmd == "fs.configure":
        return C.fs_configure(env, location_prefix=flags.get("locationPrefix", ""),
                              collection=flags.get("collection", ""),
                              replication=flags.get("replication", ""),
                              ttl=flags.get("ttl", ""),
                              fsync=flags.get("fsync") == "true",
                              apply=flags.get("apply") == "true",
                              delete=flags.get("delete") == "true")
    if cmd == "bucket.list":
        return C.bucket_list(env)
    if cmd == "bucket.create":
        return C.bucket_create(env, flags["name"])
    if cmd == "bucket.delete":
        return C.bucket_delete(env, flags["name"])
    if cmd == "query":
        return C.query(env, args[0] if args else "", flags.get("path", ""),
                       flags.get("input", "csv"))
    if cmd == "trace":
        tid = flags.get("id", "") or (args[0] if args else "")
        if not tid:
            raise ValueError("usage: trace TRACE_ID (or trace -id=TRACE_ID)")
        return C.trace_collect(env, tid)
    if cmd == "remote.dlq":
        return C.remote_dlq(env, flags.get("dir", ""), replay=flags.get("replay") == "true",
                            direction=flags.get("direction", ""))
    if cmd == "lock":
        return env.lock()
    if cmd == "unlock":
        env.unlock()
        return "ok"
    return f"unknown command {cmd!r} (try help)"


def _print_result(result) -> None:
    if result is not None:
        print(
            result
            if isinstance(result, str)
            else json.dumps(result, indent=2, default=str)
        )


def run_shell(master: str, filer: str = "", command: str = "") -> None:
    env = CommandEnv(master, filer=filer)
    if command:
        # one-shot mode (weed shell accepts piped commands the same way)
        failed = False
        try:
            for line in command.split(";"):
                try:
                    result = run_command_with_failover(env, line)
                except EOFError:  # 'exit' in a script is a clean stop
                    break
                except Exception as e:  # noqa: BLE001
                    print(f"error: {e}")
                    failed = True
                    continue
                _print_result(result)
        finally:
            env.unlock()  # never leak the cluster admin lock
        if failed:
            raise SystemExit(1)
        return
    print(f"connected to master {master}; 'help' for commands")
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            break
        try:
            result = run_command_with_failover(env, line)
        except EOFError:
            break
        except Exception as e:  # noqa: BLE001
            print(f"error: {e}")
            continue
        _print_result(result)
    env.unlock()
