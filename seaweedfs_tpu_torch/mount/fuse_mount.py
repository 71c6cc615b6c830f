"""Kernel-visible FUSE mount over the WFS ops (weed mount): the port's copy
of the JAX package's ``mount/fuse_mount.py``.

The reference mounts the filer as a real filesystem through bazil.org/fuse
(`weed/filesys/wfs.go:55`, `weed/command/mount_std.go:51`) so unmodified
programs (`ls`, `cp`, editors) work against the store.  This module does the
same through a ctypes binding of libfuse 2.x (the runtime .so ships on
stock Linux; no Python fuse package is required): each FUSE callback maps
onto the `mount.wfs.WFS` operations, which carry the meta cache, chunked
uploads, and the filer's cipher setting.

Gating: `fuse_available()` is False when libfuse/`/dev/fuse` are absent or
the machine is not x86_64 — callers (CLI, tests) fall back to the
FUSE-less sync daemon (mount/sync.py). libfuse is loaded when a
``FuseMount`` is made, never at import.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import stat as stat_mod
import subprocess
import threading
import time
from typing import Optional

from ..util import glog
from .wfs import WFS, FileHandle

# -- libfuse 2.x ABI ---------------------------------------------------------

c_void_p = ctypes.c_void_p
c_char_p = ctypes.c_char_p
c_int = ctypes.c_int
c_uint = ctypes.c_uint
c_size_t = ctypes.c_size_t
c_off_t = ctypes.c_longlong
c_mode_t = ctypes.c_uint
c_dev_t = ctypes.c_ulonglong
c_uid_t = ctypes.c_uint
c_gid_t = ctypes.c_uint


class Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


class Stat(ctypes.Structure):
    """x86_64 linux struct stat."""

    _fields_ = [
        ("st_dev", ctypes.c_ulong),
        ("st_ino", ctypes.c_ulong),
        ("st_nlink", ctypes.c_ulong),
        ("st_mode", c_mode_t),
        ("st_uid", c_uid_t),
        ("st_gid", c_gid_t),
        ("__pad0", ctypes.c_int),
        ("st_rdev", ctypes.c_ulong),
        ("st_size", ctypes.c_long),
        ("st_blksize", ctypes.c_long),
        ("st_blocks", ctypes.c_long),
        ("st_atim", Timespec),
        ("st_mtim", Timespec),
        ("st_ctim", Timespec),
        ("__glibc_reserved", ctypes.c_long * 3),
    ]


class FuseFileInfo(ctypes.Structure):
    """libfuse 2.9 struct fuse_file_info."""

    _fields_ = [
        ("flags", c_int),
        ("fh_old", ctypes.c_ulong),
        ("writepage", c_int),
        ("bits", c_uint),  # direct_io/keep_cache/... bitfield
        ("fh", ctypes.c_uint64),
        ("lock_owner", ctypes.c_uint64),
    ]


_GETATTR = ctypes.CFUNCTYPE(c_int, c_char_p, ctypes.POINTER(Stat))
_READLINK = ctypes.CFUNCTYPE(c_int, c_char_p, c_char_p, c_size_t)
_GETDIR = c_void_p  # deprecated slot
_MKNOD = ctypes.CFUNCTYPE(c_int, c_char_p, c_mode_t, c_dev_t)
_MKDIR = ctypes.CFUNCTYPE(c_int, c_char_p, c_mode_t)
_UNLINK = ctypes.CFUNCTYPE(c_int, c_char_p)
_RMDIR = ctypes.CFUNCTYPE(c_int, c_char_p)
_SYMLINK = ctypes.CFUNCTYPE(c_int, c_char_p, c_char_p)
_RENAME = ctypes.CFUNCTYPE(c_int, c_char_p, c_char_p)
_LINK = ctypes.CFUNCTYPE(c_int, c_char_p, c_char_p)
_CHMOD = ctypes.CFUNCTYPE(c_int, c_char_p, c_mode_t)
_CHOWN = ctypes.CFUNCTYPE(c_int, c_char_p, c_uid_t, c_gid_t)
_TRUNCATE = ctypes.CFUNCTYPE(c_int, c_char_p, c_off_t)
_UTIME = c_void_p  # deprecated slot
_OPEN = ctypes.CFUNCTYPE(c_int, c_char_p, ctypes.POINTER(FuseFileInfo))
_READ = ctypes.CFUNCTYPE(
    c_int, c_char_p, ctypes.POINTER(ctypes.c_char), c_size_t, c_off_t,
    ctypes.POINTER(FuseFileInfo),
)
_WRITE = ctypes.CFUNCTYPE(
    c_int, c_char_p, ctypes.POINTER(ctypes.c_char), c_size_t, c_off_t,
    ctypes.POINTER(FuseFileInfo),
)
_STATFS = ctypes.CFUNCTYPE(c_int, c_char_p, c_void_p)
_FLUSH = ctypes.CFUNCTYPE(c_int, c_char_p, ctypes.POINTER(FuseFileInfo))
_RELEASE = ctypes.CFUNCTYPE(c_int, c_char_p, ctypes.POINTER(FuseFileInfo))
_FSYNC = ctypes.CFUNCTYPE(c_int, c_char_p, c_int, ctypes.POINTER(FuseFileInfo))
_FILL_DIR = ctypes.CFUNCTYPE(
    c_int, c_void_p, c_char_p, ctypes.POINTER(Stat), c_off_t
)
_READDIR = ctypes.CFUNCTYPE(
    c_int, c_char_p, c_void_p, _FILL_DIR, c_off_t,
    ctypes.POINTER(FuseFileInfo),
)
_INIT = ctypes.CFUNCTYPE(c_void_p, c_void_p)
_DESTROY = ctypes.CFUNCTYPE(None, c_void_p)
_ACCESS = ctypes.CFUNCTYPE(c_int, c_char_p, c_int)
_CREATE = ctypes.CFUNCTYPE(
    c_int, c_char_p, c_mode_t, ctypes.POINTER(FuseFileInfo)
)
_FTRUNCATE = ctypes.CFUNCTYPE(
    c_int, c_char_p, c_off_t, ctypes.POINTER(FuseFileInfo)
)
_FGETATTR = ctypes.CFUNCTYPE(
    c_int, c_char_p, ctypes.POINTER(Stat), ctypes.POINTER(FuseFileInfo)
)
_UTIMENS = ctypes.CFUNCTYPE(c_int, c_char_p, ctypes.POINTER(Timespec * 2))
_SETXATTR = ctypes.CFUNCTYPE(
    c_int, c_char_p, c_char_p, ctypes.POINTER(ctypes.c_char), c_size_t, c_int
)
_GETXATTR = ctypes.CFUNCTYPE(
    c_int, c_char_p, c_char_p, ctypes.POINTER(ctypes.c_char), c_size_t
)
_LISTXATTR = ctypes.CFUNCTYPE(
    c_int, c_char_p, ctypes.POINTER(ctypes.c_char), c_size_t
)
_REMOVEXATTR = ctypes.CFUNCTYPE(c_int, c_char_p, c_char_p)


class FuseOperations(ctypes.Structure):
    """libfuse 2.9 struct fuse_operations (field order is the ABI)."""

    _fields_ = [
        ("getattr", _GETATTR),
        ("readlink", _READLINK),
        ("getdir", _GETDIR),
        ("mknod", _MKNOD),
        ("mkdir", _MKDIR),
        ("unlink", _UNLINK),
        ("rmdir", _RMDIR),
        ("symlink", _SYMLINK),
        ("rename", _RENAME),
        ("link", _LINK),
        ("chmod", _CHMOD),
        ("chown", _CHOWN),
        ("truncate", _TRUNCATE),
        ("utime", _UTIME),
        ("open", _OPEN),
        ("read", _READ),
        ("write", _WRITE),
        ("statfs", _STATFS),
        ("flush", _FLUSH),
        ("release", _RELEASE),
        ("fsync", _FSYNC),
        ("setxattr", _SETXATTR),
        ("getxattr", _GETXATTR),
        ("listxattr", _LISTXATTR),
        ("removexattr", _REMOVEXATTR),
        ("opendir", c_void_p),
        ("readdir", _READDIR),
        ("releasedir", c_void_p),
        ("fsyncdir", c_void_p),
        ("init", _INIT),
        ("destroy", _DESTROY),
        ("access", _ACCESS),
        ("create", _CREATE),
        ("ftruncate", _FTRUNCATE),
        ("fgetattr", _FGETATTR),
        ("lock", c_void_p),
        ("utimens", _UTIMENS),
        ("bmap", c_void_p),
        ("flags", c_uint),  # nullpath_ok etc. bitfield word
        ("ioctl", c_void_p),
        ("poll", c_void_p),
        ("write_buf", c_void_p),
        ("read_buf", c_void_p),
        ("flock", c_void_p),
        ("fallocate", c_void_p),
    ]


def _find_libfuse() -> Optional[str]:
    for cand in (ctypes.util.find_library("fuse"), "libfuse.so.2"):
        if not cand:
            continue
        try:
            ctypes.CDLL(cand)
            return cand
        except OSError:
            continue
    return None


def fuse_available() -> bool:
    # the Stat/FuseFileInfo ctypes layouts below encode the x86_64 Linux
    # ABI; on other arches (aarch64 reorders struct stat fields) a mount
    # would come up and then feed the kernel garbage metadata — fall back
    # to the sync daemon there instead
    import platform

    return (
        platform.machine() == "x86_64"
        and _find_libfuse() is not None
        and os.path.exists("/dev/fuse")
    )


class FuseMount:
    """Mount a WFS (filer view) at a local mountpoint through libfuse2.

    The event loop runs on a dedicated thread (single-threaded FUSE loop:
    `-s` — the WFS meta cache and filer client are the shared state, and
    the Python side is GIL-serialized anyway).  `unmount()` (or the process
    exiting) detaches via fusermount -u.
    """

    def __init__(self, wfs: WFS, mountpoint: str, allow_other: bool = False,
                 root: str = "/"):
        lib = _find_libfuse()
        if lib is None:
            raise RuntimeError("libfuse 2.x not found")
        # filer sub-tree exposed at the mountpoint (weed mount -filer.path)
        self.root = "/" + root.strip("/") if root.strip("/") else ""
        self._lib = ctypes.CDLL(lib)
        self._lib.fuse_main_real.restype = c_int
        self._lib.fuse_main_real.argtypes = [
            c_int, ctypes.POINTER(c_char_p), ctypes.POINTER(FuseOperations),
            c_size_t, c_void_p,
        ]
        self.wfs = wfs
        self.mountpoint = os.path.abspath(mountpoint)
        self.allow_other = allow_other
        self._handles: dict[int, FileHandle] = {}
        self._next_fh = 1
        self._hlock = threading.Lock()
        self._ops = self._build_ops()  # keep callbacks alive
        self._thread: Optional[threading.Thread] = None
        self._rc: Optional[int] = None

    def _fp(self, path: bytes) -> str:
        """Kernel path → filer path under the mounted sub-tree."""
        p = path.decode()
        if not self.root:
            return p
        return self.root if p == "/" else self.root + p

    def _commit_entry(self, path: str, entry) -> None:
        """Persist changed metadata (filer create is an upsert)."""
        self.wfs._commit_meta(path, entry)

    # -- op table -------------------------------------------------------------
    def _build_ops(self) -> FuseOperations:
        def guard(fn):
            def wrapper(*a):
                try:
                    return fn(*a)
                except FileNotFoundError:
                    return -errno.ENOENT
                except FileExistsError:
                    return -errno.EEXIST
                except IsADirectoryError:
                    return -errno.EISDIR
                except NotADirectoryError:
                    return -errno.ENOTDIR
                except PermissionError:
                    return -errno.EACCES
                except OSError as e:
                    return -(e.errno or errno.EIO)
                except Exception:
                    glog.exception("fuse op failed")
                    return -errno.EIO

            return wrapper

        def fill_stat(st, entry) -> None:
            ctypes.memset(ctypes.byref(st), 0, ctypes.sizeof(Stat))
            if entry.is_directory:
                st.st_mode = stat_mod.S_IFDIR | (entry.mode & 0o7777)
                st.st_nlink = 2
            else:
                st.st_mode = stat_mod.S_IFREG | (entry.mode & 0o7777)
                st.st_nlink = 1
                st.st_size = entry.file_size()
            st.st_uid = entry.uid or os.getuid()
            st.st_gid = entry.gid or os.getgid()
            st.st_blksize = 4096
            st.st_blocks = (st.st_size + 511) // 512
            st.st_mtim.tv_sec = entry.mtime
            st.st_ctim.tv_sec = entry.crtime or entry.mtime
            st.st_atim.tv_sec = entry.mtime

        @guard
        def op_getattr(path, st):
            p = self._fp(path)
            try:
                entry = self.wfs.stat(p)
            except FileNotFoundError:
                if path != b"/":
                    raise
                # a fresh filer has no "/" entry; the mount root must
                # always stat (the kernel getattrs it while mounting)
                from ..filer.entry import Entry

                entry = Entry(full_path="/", is_directory=True, mode=0o755)
            fill_stat(st.contents, entry)
            return 0

        @guard
        def op_readdir(path, buf, fill, offset, fi):
            fill(buf, b".", None, 0)
            fill(buf, b"..", None, 0)
            for e in self.wfs.listdir(self._fp(path)):
                name = e.full_path.rsplit("/", 1)[-1]
                fill(buf, name.encode(), None, 0)
            return 0

        @guard
        def op_mkdir(path, mode):
            self.wfs.mkdir(self._fp(path), mode & 0o7777)
            return 0

        @guard
        def op_unlink(path):
            self.wfs.unlink(self._fp(path))
            return 0

        @guard
        def op_rmdir(path):
            self.wfs.rmdir(self._fp(path))
            return 0

        @guard
        def op_rename(old, new):
            self.wfs.rename(self._fp(old), self._fp(new))
            return 0

        @guard
        def op_chmod(path, mode):
            p = self._fp(path)
            entry = self.wfs.stat(p)
            entry.mode = mode & 0o7777
            self._commit_entry(p, entry)
            return 0

        @guard
        def op_chown(path, uid, gid):
            p = self._fp(path)
            entry = self.wfs.stat(p)
            if uid != 0xFFFFFFFF:
                entry.uid = uid
            if gid != 0xFFFFFFFF:
                entry.gid = gid
            self._commit_entry(p, entry)
            return 0

        def _register(h: FileHandle) -> int:
            with self._hlock:
                fh = self._next_fh
                self._next_fh += 1
                self._handles[fh] = h
            return fh

        @guard
        def op_create(path, mode, fi):
            p = self._fp(path)
            h = self.wfs.open(p, "w")
            if (mode & 0o7777) != h.entry.mode:
                # WFS.open('w') already committed the entry with the default
                # mode; persist the kernel-requested one or `touch`-style
                # empty creates stat with the wrong permissions
                h.entry.mode = mode & 0o7777
                self._commit_entry(p, h.entry)
            fi.contents.fh = _register(h)
            return 0

        @guard
        def op_open(path, fi):
            flags = fi.contents.flags
            mode = "r"
            if flags & (os.O_WRONLY | os.O_RDWR):
                mode = "r+"
            if flags & os.O_TRUNC:
                mode = "w"
            h = self.wfs.open(self._fp(path), mode)
            fi.contents.fh = _register(h)
            return 0

        @guard
        def op_read(path, buf, size, offset, fi):
            h = self._handles.get(fi.contents.fh)
            if h is None:
                return -errno.EBADF
            data = h.read(offset, size)
            ctypes.memmove(buf, data, len(data))
            return len(data)

        @guard
        def op_write(path, buf, size, offset, fi):
            h = self._handles.get(fi.contents.fh)
            if h is None:
                return -errno.EBADF
            data = ctypes.string_at(buf, size)
            return h.write(offset, data)

        @guard
        def op_truncate(path, length):
            with self.wfs.open(self._fp(path), "r+") as h:
                h.truncate(length)
            return 0

        @guard
        def op_ftruncate(path, length, fi):
            h = self._handles.get(fi.contents.fh)
            if h is None:
                return -errno.EBADF
            h.truncate(length)
            return 0

        @guard
        def op_fgetattr(path, st, fi):
            h = self._handles.get(fi.contents.fh)
            if h is None:
                return -errno.EBADF
            fill_stat(st.contents, h.entry)
            st.contents.st_size = max(st.contents.st_size, h.size())
            return 0

        @guard
        def op_flush(path, fi):
            h = self._handles.get(fi.contents.fh)
            if h is not None:
                h.flush()
            return 0

        @guard
        def op_release(path, fi):
            with self._hlock:
                h = self._handles.pop(fi.contents.fh, None)
            if h is not None:
                h.close()
            return 0

        @guard
        def op_fsync(path, datasync, fi):
            h = self._handles.get(fi.contents.fh)
            if h is not None:
                h.flush()
            return 0

        @guard
        def op_access(path, amode):
            p = self._fp(path)
            if path != b"/" and not self.wfs.exists(p):
                return -errno.ENOENT
            return 0

        @guard
        def op_utimens(path, times):
            p = self._fp(path)
            entry = self.wfs.stat(p)
            if times:
                entry.mtime = times.contents[1].tv_sec or int(time.time())
            else:
                entry.mtime = int(time.time())
            self._commit_entry(p, entry)
            return 0

        @guard
        def op_setxattr(path, name, value, size, flags):
            if name.startswith(b"security."):
                # refused symmetrically with getxattr's fast ENODATA — a
                # stored-but-unreadable attribute would confuse rsync -X
                return -errno.EOPNOTSUPP
            p = self._fp(path)
            data = ctypes.string_at(value, size) if size else b""
            self.wfs.setxattr(
                p, name.decode(), data,
                create=flags == 1, replace=flags == 2,  # XATTR_CREATE/REPLACE
            )
            return 0

        @guard
        def op_getxattr(path, name, buf, size):
            if name == b"security.capability":
                # the kernel probes this before EVERY write; never stored
                # here (file capabilities on a network mount are not a
                # thing), so answer without a filer lookup
                return -errno.ENODATA
            p = self._fp(path)
            raw = self.wfs.getxattr(p, name.decode())
            if size == 0:
                return len(raw)  # probe call: report needed length
            if size < len(raw):
                return -errno.ERANGE
            ctypes.memmove(buf, raw, len(raw))
            return len(raw)

        @guard
        def op_listxattr(path, buf, size):
            p = self._fp(path)
            blob = b"".join(
                n.encode() + b"\x00" for n in self.wfs.listxattr(p)
            )
            if size == 0:
                return len(blob)
            if size < len(blob):
                return -errno.ERANGE
            ctypes.memmove(buf, blob, len(blob))
            return len(blob)

        @guard
        def op_removexattr(path, name):
            self.wfs.removexattr(self._fp(path), name.decode())
            return 0

        ops = FuseOperations()
        ops.setxattr = _SETXATTR(op_setxattr)
        ops.getxattr = _GETXATTR(op_getxattr)
        ops.listxattr = _LISTXATTR(op_listxattr)
        ops.removexattr = _REMOVEXATTR(op_removexattr)
        ops.getattr = _GETATTR(op_getattr)
        ops.mkdir = _MKDIR(op_mkdir)
        ops.unlink = _UNLINK(op_unlink)
        ops.rmdir = _RMDIR(op_rmdir)
        ops.rename = _RENAME(op_rename)
        ops.chmod = _CHMOD(op_chmod)
        ops.chown = _CHOWN(op_chown)
        ops.truncate = _TRUNCATE(op_truncate)
        ops.open = _OPEN(op_open)
        ops.read = _READ(op_read)
        ops.write = _WRITE(op_write)
        ops.flush = _FLUSH(op_flush)
        ops.release = _RELEASE(op_release)
        ops.fsync = _FSYNC(op_fsync)
        ops.readdir = _READDIR(op_readdir)
        ops.access = _ACCESS(op_access)
        ops.create = _CREATE(op_create)
        ops.ftruncate = _FTRUNCATE(op_ftruncate)
        ops.fgetattr = _FGETATTR(op_fgetattr)
        ops.utimens = _UTIMENS(op_utimens)
        return ops

    # -- lifecycle -------------------------------------------------------------
    def mount(self, foreground: bool = False) -> "FuseMount":
        os.makedirs(self.mountpoint, exist_ok=True)
        args = [b"seaweedfs_tpu", self.mountpoint.encode(), b"-f", b"-s"]
        opts = b"big_writes,default_permissions"
        if self.allow_other:
            opts += b",allow_other"
        args += [b"-o", opts]
        argv = (c_char_p * len(args))(*args)

        def run():
            self._rc = self._lib.fuse_main_real(
                len(args), argv, ctypes.byref(self._ops),
                ctypes.sizeof(self._ops), None,
            )
            # libfuse2's teardown restores SIGPIPE to SIG_DFL (it saved the
            # disposition before Python's ignore was visible to it); without
            # re-ignoring, the next EPIPE on any socket KILLS the process
            # instead of raising BrokenPipeError. ctypes because
            # signal.signal() refuses to run outside the main thread.
            try:
                libc = ctypes.CDLL(None, use_errno=True)
                libc.signal.restype = ctypes.c_void_p
                libc.signal.argtypes = [ctypes.c_int, ctypes.c_void_p]
                libc.signal(13, ctypes.c_void_p(1))  # SIGPIPE → SIG_IGN
            except Exception:
                glog.warning("could not re-ignore SIGPIPE after fuse exit")

        if foreground:
            run()
            return self
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        # wait for the kernel mount to appear (or the loop to die)
        deadline = time.time() + 10
        while time.time() < deadline:
            if self._rc is not None and self._rc != 0:
                raise RuntimeError(f"fuse_main failed rc={self._rc}")
            if os.path.ismount(self.mountpoint):
                return self
            time.sleep(0.05)
        raise RuntimeError("fuse mount did not appear within 10s")

    def unmount(self) -> None:
        # plain unmount first; if the mount is busy, fall back to a lazy
        # detach — a mountpoint left behind surfaces later as "Transport
        # endpoint is not connected" when the directory tree is removed
        for cmd in (["fusermount", "-u", self.mountpoint],
                    ["umount", self.mountpoint],
                    ["fusermount", "-uz", self.mountpoint],
                    ["umount", "-l", self.mountpoint]):
            try:
                r = subprocess.run(cmd, capture_output=True, timeout=10)
                if r.returncode == 0:
                    break
            except (OSError, subprocess.TimeoutExpired):
                continue
        # wait for the detach to land before the caller deletes the tree
        for _ in range(50):
            if not os.path.ismount(self.mountpoint):
                break
            time.sleep(0.1)
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._hlock:
            handles, self._handles = dict(self._handles), {}
        for h in handles.values():
            try:
                h.close()
            except Exception:  # sweedlint: ok broad-except best-effort handle drain on unmount; nothing to do with a failed close
                pass
