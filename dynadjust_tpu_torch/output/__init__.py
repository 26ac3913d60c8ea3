from .adj_writer import write_adj, write_xyz, format_dms
