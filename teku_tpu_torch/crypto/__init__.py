"""Host-side BLS12-381: the port's own copies of the oracle and the SPI."""
