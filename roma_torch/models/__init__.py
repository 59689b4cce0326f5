"""Full RoMa model stack and the matcher API."""
