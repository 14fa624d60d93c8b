"""join_carried_bytes_per_query: the program's ``JoinCarriedBytes``
counter (rows times storage width of every column a join materializes)
over its ``Query`` counter, in MB, both read when the run's statements
are done: every statement of the process is one of the cell's.  None
where the program keeps no such counter."""


def read(r):
    from myscaledb_tpu_torch.runtime import metrics
    events = metrics.events_snapshot()
    carried = events.get("JoinCarriedBytes")
    queries = events.get("Query")
    if carried is None or not queries:
        return None
    return carried / queries / 1e6
