"""Text-format parsing for COPY: csv and pipe-delimited (dbgen .tbl).

Counterpart of citus_tpu/ingest/parse.py (the Python reader).
"""

from __future__ import annotations

import csv as _csv

from ..errors import IngestError


def iter_text_batches(path: str, delimiter: str, header: bool,
                      null_string: str, n_columns: int, batch_rows: int):
    """Yields batches: list of per-column python-value lists (str|None)."""
    try:
        f = open(path, newline="")
    except OSError as exc:
        raise IngestError(f"cannot open {path!r}: {exc}") from exc
    with f:
        reader = _csv.reader(f, delimiter=delimiter)
        if header:
            next(reader, None)
        batch: list[list] = [[] for _ in range(n_columns)]
        count = 0
        for lineno, row in enumerate(reader, start=1 + int(header)):
            if not row:
                continue
            # dbgen .tbl lines end with a trailing delimiter → extra field
            if len(row) == n_columns + 1 and row[-1] == "":
                row = row[:-1]
            if len(row) != n_columns:
                raise IngestError(
                    f"{path}:{lineno}: expected {n_columns} fields, "
                    f"got {len(row)}")
            for i, cell in enumerate(row):
                batch[i].append(None if cell == null_string and
                                (null_string or cell == "") else cell)
            count += 1
            if count >= batch_rows:
                yield batch
                batch = [[] for _ in range(n_columns)]
                count = 0
        if count:
            yield batch
