"""Matrix files (readers) and Nektar++ session meshes (nektar)."""
from saena_tpu_torch.io.readers import read_bin, read_mtx, read_matrix, write_bin, write_mtx
