from .io import atomic_write_json, fsync_dir

__all__ = ["atomic_write_json", "fsync_dir"]
