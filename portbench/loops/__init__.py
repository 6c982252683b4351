"""One loop per configuration entry and traffic kind: portbench/loops/<entry>_<kind>.py."""
