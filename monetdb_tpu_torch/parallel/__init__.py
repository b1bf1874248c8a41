"""Intra-query data parallelism over a row mesh — the port of the reference
package's replacement for MonetDB's mitosis/mergetable/mat.pack pipeline
(monetdb5/optimizer/opt_mitosis.c, opt_mergetable.c, modules/mal/mat.c):
rows are range-partitioned across shards, operators run once per shard
(one thread each in one process, parallel/mesh.py; or in processes of one
shard each, or of one thread per local device each, parallel/dist.py),
and the merge step is a collective (psum for partial aggregates,
all_gather only at result export)."""

from .mitosis import (shard_array, row_mesh, two_phase_sum,  # noqa: F401
                      sharded_q1, sharded_q6, default_mesh)
from .dist import (ProcessMesh, initialize, process_index,  # noqa: F401
                   process_count, shutdown)
