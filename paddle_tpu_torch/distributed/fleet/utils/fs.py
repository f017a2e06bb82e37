"""``fleet.utils`` file-system clients.

Port of ``paddle_tpu/distributed/fleet/utils/fs.py`` (Paddle's
``fleet/utils/fs.py``): ``LocalFS`` works on local paths; ``HDFSClient``
needs a hadoop installation and a cluster, which the port does not
assume, and raises at construction."""
from __future__ import annotations

import os
import shutil

__all__ = ["LocalFS", "HDFSClient", "FSFileExistsError",
           "FSFileNotExistsError"]


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class LocalFS:
    """The local file system (Paddle's ``LocalFS``)."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for f in os.listdir(fs_path):
            if os.path.isdir(os.path.join(fs_path, f)):
                dirs.append(f)
            else:
                files.append(f)
        return dirs, files

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def delete(self, fs_path):
        if not self.is_exist(fs_path):
            return
        if os.path.isfile(fs_path):
            os.remove(fs_path)
        else:
            shutil.rmtree(fs_path)

    def need_upload_download(self):
        return False

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if exist_ok:
                return
            raise FSFileExistsError(fs_path)
        with open(fs_path, "a"):
            pass

    def mv(self, src_path, dst_path, overwrite=False, test_exists=True):
        if test_exists:
            if not self.is_exist(src_path):
                raise FSFileNotExistsError(src_path)
            if self.is_exist(dst_path) and not overwrite:
                raise FSFileExistsError(dst_path)
        if self.is_exist(dst_path) and overwrite:
            self.delete(dst_path)
        os.rename(src_path, dst_path)

    def list_dirs(self, fs_path):
        if not self.is_exist(fs_path):
            return []
        return [f for f in os.listdir(fs_path)
                if os.path.isdir(os.path.join(fs_path, f))]


class HDFSClient:
    """Paddle's ``HDFSClient`` shells out to ``hadoop fs``: not ported."""

    def __init__(self, hadoop_home=None, configs=None, *a, **k):
        raise NotImplementedError(
            "HDFSClient needs a hadoop installation and cluster "
            "connectivity; use LocalFS (or mount the data locally)")
