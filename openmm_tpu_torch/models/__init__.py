from .builders import (alchemical_water_box, argon_gas, hippo_water_cluster,
                       popc_bilayer, popc_gb_cluster,
                       popc_obc_cluster,
                       tip3p_water_box, tip4pew_water_box, water_droplet)

__all__ = ["alchemical_water_box", "argon_gas", "hippo_water_cluster",
           "popc_bilayer", "popc_gb_cluster",
           "popc_obc_cluster",
           "tip3p_water_box", "tip4pew_water_box", "water_droplet"]
