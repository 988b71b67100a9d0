"""The harness: finds a cell's configuration, traffic mix and metric
readers by name, runs the cell's driver (``<kind>_cell``), and prints
the result line."""
