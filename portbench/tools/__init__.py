"""Studies that set the limits: the program's readings over many seeds, the precision
control's and each planted fault's."""
