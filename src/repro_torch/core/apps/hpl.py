"""HPL application geometry (paper §III-C): ScaLAPACK ``numroc`` and the
run configuration.

Right-looking LU with block size ``nb`` on a P x Q block-cyclic process
grid, ranks laid out column-major (rank r sits at p = r % P,
q = r // P).  The discrete-event application (``HPLSim``) is not ported
yet; the vectorized simulator (``core.fastsim``) needs only the
geometry below.
"""
from __future__ import annotations

import dataclasses


def numroc(n: int, nb: int, iproc: int, nprocs: int) -> int:
    """ScaLAPACK NUMROC: local rows/cols of an n-length dim distributed in
    nb blocks over nprocs, for process iproc (src proc 0)."""
    nblocks = n // nb
    base = (nblocks // nprocs) * nb
    extra = nblocks % nprocs
    if iproc < extra:
        base += nb
    elif iproc == extra:
        base += n % nb
    return base


@dataclasses.dataclass
class HPLConfig:
    N: int
    nb: int
    P: int
    Q: int
    bcast: str = "1ring"          # 1ring | long
    lookahead: int = 0            # modeled depth (0: panel on critical path)

    def __post_init__(self):
        if self.N < 1 or self.nb < 1:
            raise ValueError(f"HPLConfig: N={self.N}, nb={self.nb} must be "
                             ">= 1")
        if self.P < 1 or self.Q < 1:
            raise ValueError(f"HPLConfig: P={self.P}, Q={self.Q} must be "
                             ">= 1")
        if self.bcast not in ("1ring", "long"):
            raise ValueError(f"HPLConfig: bcast={self.bcast!r} not in "
                             "('1ring', 'long')")
        if self.lookahead not in (0, 1):
            raise ValueError(f"HPLConfig: lookahead={self.lookahead} must "
                             "be 0 or 1")
        # N % nb != 0 is legal: the trailing partial panel is modeled
        # (ceil(N/nb) panels, last one N % nb wide) — see n_panels.

    @property
    def n_ranks(self) -> int:
        return self.P * self.Q

    @property
    def n_panels(self) -> int:
        """ceil(N / nb): a trailing N % nb panel is simulated, not
        silently dropped."""
        return (self.N + self.nb - 1) // self.nb

    def flops(self) -> float:
        return (2.0 / 3.0) * self.N ** 3 + 1.5 * self.N ** 2
