"""Plain references the benchmark holds the port against: plain torch,
no import of the system under test."""
