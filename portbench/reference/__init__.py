"""The plain reference: frozen copies of the decode chain, the parser and the NMEA encoder, importing nothing of the program."""
