"""Top-level I/O verbs (``nums_tpu/api.py``) on the active application:
``read``, ``write`` and ``delete`` of a block checkpoint (an ``s3://``
name goes to S3, any other to the filesystem), ``read_csv``, and Parquet
files to and from a BlockArray or a DiskArray. pyarrow is imported inside
the Parquet functions, so the package imports without it. Under several
processes each verb is collective, as in the reference: a Parquet read
decodes only the row groups of this process's rows, ``out=`` ingests
once on process 0 for all, and ``write_parquet`` writes on process 0."""

import numpy as np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.grid import ArrayGrid

_S3 = "s3://"


def read(filename: str):
    """Read a persisted BlockArray."""
    if filename.startswith(_S3):
        return _instance().read_s3(filename[len(_S3):])
    return _instance().read_fs(filename)


def write(ba, filename: str):
    if filename.startswith(_S3):
        return _instance().write_s3(ba, filename[len(_S3):])
    return _instance().write_fs(ba, filename)


def delete(filename: str):
    if filename.startswith(_S3):
        return _instance().delete_s3(filename[len(_S3):])
    return _instance().delete_fs(filename)


def read_csv(filename, dtype=float, delimiter=",", has_header=False,
             num_workers=None):
    return _instance().read_csv(
        filename, dtype=dtype, delimiter=delimiter, has_header=has_header,
        num_workers=num_workers,
    )


def _parquet_row_groups(pf, columns, dtype):
    assert pf.num_row_groups > 0, "parquet file has no row groups"
    for i in range(pf.num_row_groups):
        arr = pf.read_row_group(i, columns=columns).to_pandas().to_numpy()
        if dtype is not None:
            arr = arr.astype(dtype)
        yield arr


def _rechunk(panels, rows_per_panel):
    """A stream of row panels cut anew into panels of exactly
    ``rows_per_panel`` rows (the last ragged), holding one output panel."""
    assert rows_per_panel > 0, rows_per_panel
    buf = []
    have = 0
    for p in panels:
        buf.append(p)
        have += p.shape[0]
        while have >= rows_per_panel:
            cat = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
            yield cat[:rows_per_panel]
            rest = cat[rows_per_panel:]
            buf = [rest] if rest.shape[0] else []
            have = rest.shape[0]
    if have:
        yield np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]


def read_parquet(filename, columns=None, dtype=None, out=None,
                 block_rows=None):
    """A Parquet file as a BlockArray; ``block_rows`` sets its row
    blocking. With ``out=<path>`` the row groups stream to a DiskArray at
    that path instead, one group and one block in host memory at a time,
    so the file may be larger than the host's and the device's memory.
    Needs pyarrow."""
    import pyarrow.parquet as pq

    if block_rows is not None:
        assert block_rows > 0, block_rows
    from nums_tpu_torch.core import multiprocess as _mp

    pf = pq.ParquetFile(filename)
    if out is not None:
        if _mp.is_multiprocess() and _mp.process_index() != 0:
            # Collective through DiskArray.from_panels: process 0 streams
            # the row groups to the shared filesystem once (concurrent
            # writers of the same block files would tear it); the others
            # give it no panels, decode nothing, and open the result after
            # its release. (The reference wraps that collective in a second
            # publish of its own, whose barrier the peers then meet out of
            # step.)
            from nums_tpu_torch.core.array.diskarray import DiskArray

            return DiskArray.from_panels(out, _instance().fs, iter(()),
                                         None, None, None)
        return _read_parquet_ooc(pf, columns, dtype, out, block_rows)
    if _mp.is_multiprocess() and _instance().backend.mesh is not None:
        return _read_parquet_multiprocess(pf, columns, dtype, block_rows)
    from nums_tpu_torch.experimental.nums_modin import _from_row_parts

    parts = list(_parquet_row_groups(pf, columns, dtype))
    block_shape = (
        (block_rows, parts[0].shape[1]) if block_rows is not None else None
    )
    return _from_row_parts(parts, dtype=dtype, block_shape=block_shape)


def _read_parquet_ooc(pf, columns, dtype, out, block_rows):
    """Stream the row groups to a DiskArray at ``out``. Width and dtype
    come from the first group as decoded (the schema misleads on a pandas
    index column and on nullable integers that decode to float64); the
    stream goes on after it, so no group is decoded twice."""
    from nums_tpu_torch.core.array.diskarray import DiskArray

    n = pf.metadata.num_rows
    groups = _parquet_row_groups(pf, columns, dtype)
    first = next(groups)
    d = first.shape[1]
    out_dtype = np.dtype(dtype) if dtype is not None else first.dtype
    if block_rows is None:
        block_rows = max(1, min(n, first.shape[0]))

    def panels():
        yield first
        yield from groups  # goes on from row group 1

    return DiskArray.from_panels(
        out, _instance().fs, _rechunk(panels(), block_rows), (n, d),
        out_dtype, block_rows,
    )


def _read_parquet_multiprocess(pf, columns, dtype, block_rows):
    """``read_parquet`` under several processes (collective; a shared
    filesystem): each process decodes only the row groups that overlap its
    region (their bounds come from the file's metadata). Group 0 is decoded
    everywhere to fix the width and dtype."""
    from nums_tpu_torch.core import multiprocess as _mp
    from nums_tpu_torch.core.io.filesystem import (
        region_array, row_region_loader,
    )

    backend = _instance().backend
    n = pf.metadata.num_rows
    group_rows = [pf.metadata.row_group(i).num_rows
                  for i in range(pf.num_row_groups)]
    starts = np.concatenate([[0], np.cumsum(group_rows)])

    def decode(i):
        arr = pf.read_row_group(i, columns=columns).to_pandas().to_numpy()
        return arr.astype(dtype) if dtype is not None else arr

    first = decode(0)
    d = first.shape[1]
    out_dtype = np.dtype(dtype) if dtype is not None else first.dtype
    rows_per_block = block_rows or max(1, n // max(1, backend.num_devices))
    grid = ArrayGrid((n, d), (min(rows_per_block, n), d), out_dtype.name)

    def fill_rows(r0, r1, c0, c1, out):
        g0 = int(np.searchsorted(starts, r0, side="right")) - 1
        for g in range(max(0, g0), len(group_rows)):
            if starts[g] >= r1:
                break
            lo, hi = max(r0, int(starts[g])), min(r1, int(starts[g + 1]))
            if lo >= hi:
                continue
            arr = first if g == 0 else decode(g)
            out[lo - r0:hi - r0] = arr[lo - starts[g]:hi - starts[g],
                                       c0:c1].astype(out_dtype, copy=False)

    load_region = row_region_loader((n, d), out_dtype, fill_rows)
    return _mp.stage("read_parquet", "read_parquet",
                     lambda: region_array(backend, grid, load_region))


def write_parquet(ba, filename: str, column_names=None,
                  row_group_rows: int = None):
    """A BlockArray or a DiskArray as a Parquet file, one row group per
    row stripe (``row_group_rows`` rows; by default a row block, or a
    DiskArray's panel): host memory holds one stripe. Needs pyarrow."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from nums_tpu_torch.core.array.diskarray import DiskArray

    assert ba.ndim == 2, ba.shape
    d = ba.shape[1]
    names = (
        list(column_names) if column_names is not None
        else [f"c{i}" for i in range(d)]
    )
    assert len(names) == d, (len(names), d)
    if row_group_rows is not None:
        assert row_group_rows > 0, row_group_rows
    from nums_tpu_torch.core import multiprocess as _mp

    multi = _mp.is_multiprocess()
    marker = f"{filename}.write-failed"
    tag = f"write_parquet:{filename}"
    what = f"write_parquet({filename!r})"
    if isinstance(ba, DiskArray):
        if multi and _mp.process_index() != 0:
            # The stripes are host reads of the shared filesystem, no
            # collective: the peers wait for process 0's release.
            _mp.await_published(tag, marker, what)
            return
        stripes = (p for _, p in ba.iter_row_panels())
        if row_group_rows is not None:
            stripes = _rechunk(stripes, int(row_group_rows))
    else:
        rows = row_group_rows or max(1, ba.block_shape[0])
        data = ba.data  # the logical view, once
        # Under several processes each stripe is gathered (collective),
        # on every process; process 0 writes it.
        stripes = (
            _mp.allgather_to_host(data[start:start + rows])
            for start in range(0, ba.shape[0], rows)
        )
    # Only the in-memory stream is collective: after a write failure it is
    # drained, so that the peers' gathers stay matched.
    collective_stream = multi and not isinstance(ba, DiskArray)

    def write_stream():
        writer, failed = None, None
        try:
            for stripe in stripes:
                if failed is not None:
                    if not collective_stream:
                        break
                    continue
                try:
                    table = pa.table(
                        {nm: stripe[:, j] for j, nm in enumerate(names)}
                    )
                    if writer is None:
                        writer = pq.ParquetWriter(filename, table.schema)
                    writer.write_table(table)
                except BaseException as e:  # noqa: BLE001 - raised below
                    failed = e
            if failed is not None:
                raise failed
            if writer is None:  # zero rows: still a valid file
                empty = pa.table(
                    {nm: np.empty(0, np.dtype(ba.dtype)) for nm in names}
                )
                writer = pq.ParquetWriter(filename, empty.schema)
                writer.write_table(empty)
        finally:
            if writer is not None:
                writer.close()

    if not multi:
        write_stream()
        return
    if _mp.process_index() == 0:
        with _mp.publishing(tag, marker):
            write_stream()
        return
    # A peer of the collective stream: gather every stripe in step with
    # process 0, reach its release barrier even where the stream failed
    # here, then raise this process's own failure before the marker check.
    try:
        for _ in stripes:
            pass
    except BaseException:
        _mp.barrier(tag)
        raise
    _mp.await_published(tag, marker, what)
