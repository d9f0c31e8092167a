"""No native extensions: the reference decoder runs in Python and NumPy.

Every module of the copied host plane asks these two functions for its C
accelerators and takes its Python path when they answer None, so no
C source and no shared library is built or loaded here.
"""


def native_cabac():
    """Always None: the CABAC, walk and filter C paths stay off."""
    return None


def native_recon():
    """Always None: the reconstruction C paths stay off."""
    return None
