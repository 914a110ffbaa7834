"""A copy of ``intentbev/utils/featherio.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_data.py`` holds what it writes and
reads against the original.

Feather V2 I/O via the Arrow IPC API.

``pyarrow.feather.read_feather`` / ``write_feather`` (and their pandas
wrappers ``pd.read_feather`` / ``DataFrame.to_feather``) are deprecated as
of pyarrow 24.0: Feather V2 IS the Arrow IPC file format, and the documented
replacement is ``pyarrow.ipc.open_file`` / ``pyarrow.ipc.new_file``. These
helpers are the single implementation used by the loader, the label
precompute CLI, the synthetic-log generator, and the tests, so the hot data
path (reference dataset.py:311 reads feather per sweep) survives the
removal release without warning spam.

Files written here are plain uncompressed Arrow IPC — readable by every
feather V2 reader, including the reference's ``pd.read_feather``.
"""

from __future__ import annotations


def read_ipc_table(path, columns=None):
    """Feather V2 / Arrow IPC file -> ``pyarrow.Table``."""
    import pyarrow as pa

    with pa.OSFile(str(path), "rb") as src:
        t = pa.ipc.open_file(src).read_all()
    if columns is not None:
        t = t.select(columns)
    return t


def read_ipc_dataframe(path, columns=None):
    """Feather V2 / Arrow IPC file -> ``pandas.DataFrame``."""
    return read_ipc_table(path, columns).to_pandas(use_threads=False)


def write_ipc_dataframe(df, path) -> None:
    """``pandas.DataFrame`` -> Feather V2 / Arrow IPC file."""
    import pyarrow as pa

    t = pa.Table.from_pandas(df, preserve_index=False)
    with pa.OSFile(str(path), "wb") as sink:
        with pa.ipc.new_file(sink, t.schema) as writer:
            writer.write_table(t)
