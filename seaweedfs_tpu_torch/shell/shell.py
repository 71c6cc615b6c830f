"""Interactive admin REPL (reference: `weed shell`, shell/commands.go).

The port runs the EC and volume-maintenance commands and what they stand on
(see ``HELP``). Every other command of the JAX package's shell raises an
error that names it as not ported yet, so a script that calls one fails
instead of doing nothing.
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
  volume.balance [-collection=C] [-force=true] [-heat]  plan (and apply) even
                 spread; -heat moves replicas off hot nodes (EWMA heat)
  volumeServer.evacuate -node=host:port         drain a server
  volumeServer.leave -node=host:port            deregister a server now
  ec.encode -volumeId=N[,M..] [-collection=C] [-fleet]
                 erasure-code + spread volume(s); -fleet hands the batch to
                 the master's scheduler, which fans generate jobs across
                 the volume servers in parallel
  ec.decode -volumeId=N [-collection=C]   turn an EC volume back to normal
  ec.rebuild -volumeId=N [-collection=C]  rebuild missing shards
  ec.balance [-collection=C]              even out shard spread
  volume.tier.upload -volumeId=N [-backend=s3.default|-endpoint=..] [-bucket=B]
                 [-keepLocal=true]   move a sealed volume's .dat to an S3 tier
  volume.tier.download -volumeId=N    bring a tiered volume's .dat back
  lifecycle.status | lifecycle.pause | lifecycle.resume   the master's autopilot
  collection.list | collection.delete -collection=C
  lock | unlock
  help | exit
"""

# the JAX package's commands that the port does not run yet
NOT_PORTED = frozenset({
    "volume.fsck", "fs.cd", "fs.pwd", "fs.ls", "fs.du", "fs.tree", "fs.cat", "fs.mv",
    "fs.meta.cat", "fs.meta.save", "fs.meta.load", "fs.meta.notify",
    "fs.configure", "bucket.list", "bucket.create", "bucket.delete", "query",
    "remote.dlq", "trace",
})


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
_RETRY_SAFE = {"help", "cluster.status", "volume.list", "collection.list",
               "lifecycle.status"}


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
    if cmd in ("exit", "quit"):
        raise EOFError
    if cmd == "help":
        return HELP
    if cmd in NOT_PORTED:
        raise NotImplementedError(
            f"{cmd} is not ported yet (the JAX package's shell runs it)")
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


def run_shell(master: str, command: str = "") -> None:
    env = CommandEnv(master)
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
