"""One closed loop a kind of traffic, named by the mix's ``loop``."""
