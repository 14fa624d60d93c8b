"""Hand the generated tensors to the program: one ``Column`` per column of
the configuration's schema, registered in a session on the device.  The
tensors are the ones the reference reads; no copy is made."""

from __future__ import annotations


def columns(schema: list, data: dict):
    """``schema`` as the configuration file gives it: ``[name, type]`` or
    ``[name, "Array(Float32)", dim]`` per column.  A String column's data is
    ``(codes, values)``: int32 codes into the list of distinct values."""
    from myscaledb_tpu_torch.core.dictionary import StringDictionary
    from myscaledb_tpu_torch.core.table import Column
    from myscaledb_tpu_torch.core.types import DataType, Field
    out = []
    for name, type_name, *dim in schema:
        dt = DataType(type_name)
        value, dictionary = data[name], None
        if dt is DataType.STRING:
            value, values = value
            dictionary = StringDictionary(values)
        field = Field(name, dt, vector_dim=int(dim[0]) if dim else 0)
        out.append(Column(field, value, None, dictionary))
    return out


def open_session(cfg: dict, data: dict, device):
    """A session on ``device`` with every table of the configuration, its
    table settings and its session settings applied."""
    from myscaledb_tpu_torch.config import TableSettings
    from myscaledb_tpu_torch.core.table import Table
    from myscaledb_tpu_torch.session import Session
    s = Session(device=device)
    for key, value in cfg.get("session_settings", {}).items():
        setattr(s.settings, key, value)
    for tname, schema in cfg["tables"].items():
        ts = None
        if tname in cfg.get("table_settings", {}):
            ts = TableSettings()
            for key, value in cfg["table_settings"][tname].items():
                setattr(ts, key, value)
        s.register(tname, Table(columns(schema, data["tables"][tname]),
                                name=tname), ts)
    return s
