from .mesh import (Mesh, MeshPairRecruiter, auto_mesh, full_step,  # noqa: F401
                   make_mesh, sharded_align, sharded_filter_scores,
                   sharded_recruit_pairs, sharded_solve, sharded_stage_solver)
