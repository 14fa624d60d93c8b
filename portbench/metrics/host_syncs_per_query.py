"""host_syncs_per_query: synchronising operations per statement, each one
warning under ``torch.cuda.set_sync_debug_mode("warn")``, over a short
phase of the cell's statements from one client after the window."""


def read(r):
    if r.syncs is None or not r.sync_statements:
        return None
    return r.syncs / r.sync_statements
