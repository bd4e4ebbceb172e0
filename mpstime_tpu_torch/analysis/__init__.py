from .analyse import (von_neumann_entropy, bipartite_spectrum, rho_correct,
                      one_site_rdm, single_site_entropy, single_site_spectrum,
                      see_variation)

__all__ = ["von_neumann_entropy", "bipartite_spectrum", "rho_correct",
           "one_site_rdm", "single_site_entropy", "single_site_spectrum",
           "see_variation"]
