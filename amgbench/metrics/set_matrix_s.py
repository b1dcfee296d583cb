"""set_matrix_s: the host wall of AMG.set_matrix, ended by a synchronize."""


def read(run):
    return run.set_matrix_s
