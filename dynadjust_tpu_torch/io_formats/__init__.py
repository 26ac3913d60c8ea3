from .dna import read_dna_stn, read_dna_msr, Station, GpsCluster, GpsObs, Measurement, DirectionSet
