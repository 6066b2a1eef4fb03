"""Cross-silo federation: the server and client FSMs over a transport."""
