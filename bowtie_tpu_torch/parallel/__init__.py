"""Scale-out over several devices: a replicated index with reads or DFS
lanes split across the devices (mesh.py, dfs_mesh.py), and the
multi-process launcher over read slices (launch.py)."""
