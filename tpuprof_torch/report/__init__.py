"""Report helpers of the port: the stats dict's machine-readable export."""
